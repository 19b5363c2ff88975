"""Multi-scale deformable attention (MSDA) sampling: two CUDA kernels, each
with its plain PyTorch version beside it.

Semantic spec (shared with ``kinet_tpu/ops/msda.py``): per level, bilinear
sampling of a value map with ``grid_sample(align_corners=False,
padding_mode="zeros")`` at the sampling locations, weighted by the attention
weights and summed over levels and points.

- ``ms_deform_attn``: the encoder's sampling core. Kernel
  ``csrc/msda_fwd.cu``. Replaces the Pallas kernel
  ``kinet_tpu/ops/pallas_msda.py::level_sample_matmul`` (wrapper
  ``ms_deform_attn_hybrid``) and the XLA formulation
  ``kinet_tpu/ops/msda.py::ms_deform_attn_quad_unroll``.
- ``ms_deform_attn_raw_pool``: the decoder's gather-then-project pooling of
  raw (pre-projection) rows. Kernel ``csrc/msda_raw_pool_fwd.cu``. Replaces
  ``kinet_tpu/ops/msda.py::ms_deform_attn_raw_pool`` with its
  ``build_raw_quad`` table.

What bounds both on an H100: the corner reads from L2 and their latency,
not HBM. Every sample reads four corner rows at data-dependent cells (a
72-byte head slice in the encoder, a 576-byte raw row in the decoder, in
bf16) plus its location and weight, for 2 flops a channel a corner; the
flagship's tables (13 MB encoder, 26 MB decoder, in bf16) stay in the 50 MB
L2, so every corner of every sample is a read from L2 again, and the HBM
bound, which counts each touched row once, is not what the kernels meet.
Both kernels fix the (levels, points) the flagship launches at compile
time, read a (query, head)'s samples as vectors, take every corner
branch-free (a corner that is not read loads cell 0 with weight 0) and
have all of a thread's corner loads in flight before its first sum; both
use wide loads: ``msda_fwd`` gives a thread 12 channels of a head in bf16
(one 16-byte and one 8-byte load a corner) and walks runs of consecutive,
raster-ordered queries, whose shared slices come from L1;
``msda_raw_pool_fwd`` gives a thread 16 bytes of a raw row. Both derive
their corners from ``corner_at`` (``csrc/msda_common.cuh``), the corner
rule of the backward kernels. Merging the corners that a query's heads
share, to fetch each distinct row once, does not pay: on the main path's
samples the heads share almost no row (PERF.md). The TPU's quad tables,
per-head unrolls and level split existed for TPU gather-speed tiers and
are not carried over.

Both are differentiable. A wrapper runs the plain version only for tensors
on the CPU, and autograd differentiates it there. For CUDA tensors it goes
through a ``torch.autograd.Function`` whose forward launches the forward
kernel (adding one to the wrapper's ``launches`` count) and whose backward
launches the backward kernel (``csrc/msda_bwd.cu``,
``csrc/msda_raw_pool_bwd.cu``; count ``bwd_launches``), or raises; it
never falls back to the plain version. The backward kernels form the
value table's gradient as a segmented reduction without floating-point
atomics (``csrc/msda_segment.cuh``). Shapes follow the JAX package:

  value              [B, S, M, D]   S = sum_l H_l * W_l
  src                [B, S, C]
  sampling_locations [B, Lq, M, L, P, 2]  (x, y) in [0, 1]
  attention_weights  [B, Lq, M, L, P]
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def level_start_index(spatial_shapes) -> Tuple[int, ...]:
    starts, cur = [], 0
    for h, w in spatial_shapes:
        starts.append(cur)
        cur += h * w
    return tuple(starts)


@functools.lru_cache(maxsize=256)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once per (values, dtype,
    device). Making it anew would copy host to device, which synchronises
    the stream, at every call. Callers never write to it. It is made outside
    inference mode, so a cache filled while serving also serves autograd."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _level_tables(spatial_shapes, device):
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return (
        device_constant(shapes, torch.int32, device),
        device_constant(level_start_index(shapes), torch.int32, device),
    )


def _check_samples(sampling_locations, attention_weights, b, n_levels, dev):
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError("sampling_locations must be [B, Lq, M, L, P, 2]")
    bl, lq, m, l, p, _ = sampling_locations.shape
    if bl != b or l != n_levels:
        raise ValueError(
            f"sampling_locations {tuple(sampling_locations.shape)} do not "
            f"match batch {b} and {n_levels} levels"
        )
    if tuple(attention_weights.shape) != (b, lq, m, l, p):
        raise ValueError(
            f"attention_weights {tuple(attention_weights.shape)} must be "
            f"{(b, lq, m, l, p)}"
        )
    for name, t in (("sampling_locations", sampling_locations),
                    ("attention_weights", attention_weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    return lq, m, l, p


def _kernel_fn(name: str, argtypes, lib: Optional[str] = None,
               restype=ctypes.c_int):
    """C function ``name`` of kernel library ``lib`` (default: ``name``)."""
    fn = getattr(cuda_build.load(lib or name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# encoder MSDA


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain version of ``ms_deform_attn``: one ``F.grid_sample`` per level,
    in float32 (float64 for float64 values). Returns [B, Lq, M * D]."""
    n, _, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    ct = torch.promote_types(value.dtype, torch.float32)
    values = value.to(ct).split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2.0 * sampling_locations - 1.0
    out = torch.zeros(n * m, d, lq, dtype=ct, device=value.device)
    for lid, (h, w) in enumerate(spatial_shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # [NM, Lq, P, 2]
        sampled = F.grid_sample(
            v, g, mode="bilinear", padding_mode="zeros", align_corners=False
        )  # [NM, D, Lq, P]
        aw = attention_weights[:, :, :, lid].transpose(1, 2).reshape(
            n * m, 1, lq, p
        )
        out += (sampled * aw).sum(-1)
    return out.view(n, m, d, lq).permute(0, 3, 1, 2).reshape(n, lq, m * d)


def _launch(name: str, argtypes, device, *args):
    """Launches kernel ``name`` on the current stream of ``device``; raises
    if the launch fails."""
    fn = _kernel_fn(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _msda_fwd(value, spatial_shapes, loc, aw):
    b, s, m, d = value.shape
    _, lq, _, l, p, _ = loc.shape
    out = torch.empty(b, lq, m * d, dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out.zero_()
    shapes_t, starts_t = _level_tables(spatial_shapes, value.device)
    _launch(
        "msda_fwd", [_P, _I, _P, _P, _P, _P, _P] + [_I] * 7 + [_P],
        value.device, value.data_ptr(), _DTYPE_CODE[value.dtype],
        shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
        aw.data_ptr(), out.data_ptr(), b, s, m, d, lq, l, p,
    )
    ms_deform_attn.launches += 1
    return out


def _segment_scratch(lib: str, n_keys: int, n_entries: int,
                     device) -> torch.Tensor:
    """The int32 scratch of one call of backward kernel ``lib`` (counts,
    offsets, tile sums, entries, slots of csrc/msda_segment.cuh), sized by
    the library's ``msda_segment_scratch_ints``; the kernel checks it."""
    if max(n_keys, n_entries) >= 2**31:
        raise ValueError(
            f"{n_keys} gradient rows or {n_entries} corners exceed the "
            "backward kernels' int32 indices"
        )
    count = _kernel_fn("msda_segment_scratch_ints", [_LL, _LL], lib, _LL)
    return torch.empty(count(n_keys, n_entries), dtype=torch.int32,
                       device=device)


def _msda_bwd(value, spatial_shapes, loc, aw, grad_out):
    b, s, m, d = value.shape
    _, lq, _, l, p, _ = loc.shape
    dvalue = torch.empty(value.shape, dtype=value.dtype, device=value.device)
    dloc = torch.empty_like(loc)
    daw = torch.empty_like(aw)
    if lq * b * m * d == 0:
        return dvalue.zero_(), dloc.zero_(), daw.zero_()
    scratch = _segment_scratch("msda_bwd", b * s * m, b * lq * m * l * p * 4,
                               value.device)
    shapes_t, starts_t = _level_tables(spatial_shapes, value.device)
    _launch(
        "msda_bwd", [_P, _I] + [_P] * 9 + [_LL] + [_I] * 7 + [_P],
        value.device, value.data_ptr(), _DTYPE_CODE[value.dtype],
        shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
        aw.data_ptr(), grad_out.data_ptr(), dvalue.data_ptr(),
        dloc.data_ptr(), daw.data_ptr(), scratch.data_ptr(), scratch.numel(),
        b, s, m, d, lq, l, p,
    )
    ms_deform_attn.bwd_launches += 1
    return dvalue, dloc, daw


class MSDeformAttnFunction(torch.autograd.Function):
    """``ms_deform_attn`` on CUDA: forward kernel ``msda_fwd``, backward
    kernel ``msda_bwd`` (dvalue summed per row in f32 and written once in
    value's dtype; dloc and daw f32)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, aw):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, aw)
        return _msda_fwd(value, spatial_shapes, loc, aw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        dvalue, dloc, daw = _msda_bwd(
            value, ctx.spatial_shapes, loc, aw,
            grad_out.float().contiguous(),
        )
        return dvalue, None, dloc, daw


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA forward: [B, S, M, D] values -> [B, Lq, M * D] float32,
    differentiable in value, sampling_locations and attention_weights.

    CPU tensors take ``ms_deform_attn_plain``; CUDA tensors go through
    ``MSDeformAttnFunction`` (kernels ``msda_fwd`` / ``msda_bwd``; f32 or
    bf16 value, f32 accumulation)."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn runs on cpu or cuda, not {value.device}")
    if value.dim() != 4:
        raise ValueError("value must be [B, S, M, D]")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    b, s, m, d = value.shape
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {s} tokens, spatial_shapes {spatial_shapes}")
    _, mh, _, _ = _check_samples(
        sampling_locations, attention_weights, b, len(spatial_shapes),
        value.device,
    )
    if mh != m:
        raise ValueError(f"sampling_locations have {mh} heads, value {m}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDeformAttnFunction.apply(
        value.contiguous(), shapes, sampling_locations.contiguous(),
        attention_weights.contiguous(),
    )


ms_deform_attn.launches = 0
ms_deform_attn.bwd_launches = 0


# ---------------------------------------------------------------------------
# decoder gather-then-project pooling


def ms_deform_attn_raw_pool_plain(
    src: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    valid_extents: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``ms_deform_attn_raw_pool``: an explicit gather of
    the four bilinear corners of every sample, in float32 (float64 for
    float64 src)."""
    b, _, c = src.shape
    _, lq, m, _, p, _ = sampling_locations.shape
    ct = torch.promote_types(src.dtype, torch.float32)
    srcf = src.to(ct)
    pooled = torch.zeros(b, lq, m, c, dtype=ct, device=src.device)
    wsum = torch.zeros(b, lq, m, dtype=ct, device=src.device)
    for lid, ((h, w), start) in enumerate(
        zip(spatial_shapes, level_start_index(spatial_shapes))
    ):
        x = sampling_locations[:, :, :, lid, :, 0] * w - 0.5  # [B, Lq, M, P]
        y = sampling_locations[:, :, :, lid, :, 1] * h - 0.5
        aw = attention_weights[:, :, :, lid]
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        xmax = torch.full_like(x, float(w - 1))
        ymax = torch.full_like(y, float(h - 1))
        if valid_extents is not None:
            ext = valid_extents[:, lid].view(b, 1, 1, 1, 2)
            ymax = torch.minimum(ymax, ext[..., 0] - 1.0)
            xmax = torch.minimum(xmax, ext[..., 1] - 1.0)
        for dy in (0, 1):
            yi = y0 + dy
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                xi = x0 + dx
                inside = (xi >= 0) & (xi <= xmax) & (yi >= 0) & (yi <= ymax)
                wt = torch.where(
                    inside, wy * (fx if dx else 1.0 - fx) * aw, 0.0
                )
                cell = (
                    start
                    + yi.clamp(0, h - 1).long() * w
                    + xi.clamp(0, w - 1).long()
                )
                rows = torch.gather(
                    srcf, 1, cell.reshape(b, -1, 1).expand(-1, -1, c)
                ).view(b, lq, m, p, c)
                pooled += (wt[..., None] * rows).sum(3)
                wsum += wt.sum(-1)
    return pooled.to(src.dtype), wsum


def _raw_pool_fwd(src, spatial_shapes, loc, aw, ext):
    b, s, c = src.shape
    _, lq, m, l, p, _ = loc.shape
    pooled = torch.empty(b, lq, m, c, dtype=src.dtype, device=src.device)
    wsum = torch.empty(b, lq, m, dtype=torch.float32, device=src.device)
    if pooled.numel() == 0:
        return pooled.zero_(), wsum.zero_()
    shapes_t, starts_t = _level_tables(spatial_shapes, src.device)
    _launch(
        "msda_raw_pool_fwd", [_P, _I] + [_P] * 7 + [_I] * 7 + [_P],
        src.device, src.data_ptr(), _DTYPE_CODE[src.dtype],
        shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
        aw.data_ptr(), None if ext is None else ext.data_ptr(),
        pooled.data_ptr(), wsum.data_ptr(), b, s, c, lq, m, l, p,
    )
    ms_deform_attn_raw_pool.launches += 1
    return pooled, wsum


def _raw_pool_bwd(src, spatial_shapes, loc, aw, ext, grad_pooled, grad_wsum):
    b, s, c = src.shape
    _, lq, m, l, p, _ = loc.shape
    dsrc = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    dloc = torch.empty_like(loc)
    daw = torch.empty_like(aw)
    if b * lq * m * c == 0:
        return dsrc.zero_(), dloc.zero_(), daw.zero_()
    scratch = _segment_scratch("msda_raw_pool_bwd", b * s,
                               b * lq * m * l * p * 4, src.device)
    shapes_t, starts_t = _level_tables(spatial_shapes, src.device)
    _launch(
        "msda_raw_pool_bwd", [_P, _I] + [_P] * 11 + [_LL] + [_I] * 7 + [_P],
        src.device, src.data_ptr(), _DTYPE_CODE[src.dtype],
        shapes_t.data_ptr(), starts_t.data_ptr(), loc.data_ptr(),
        aw.data_ptr(), None if ext is None else ext.data_ptr(),
        grad_pooled.data_ptr(), grad_wsum.data_ptr(), dsrc.data_ptr(),
        dloc.data_ptr(), daw.data_ptr(), scratch.data_ptr(), scratch.numel(),
        b, s, c, lq, m, l, p,
    )
    ms_deform_attn_raw_pool.bwd_launches += 1
    return dsrc, dloc, daw


class MSDeformAttnRawPoolFunction(torch.autograd.Function):
    """``ms_deform_attn_raw_pool`` on CUDA: forward kernel
    ``msda_raw_pool_fwd``, backward kernel ``msda_raw_pool_bwd`` (dsrc
    summed per row in f32 and written once in src's dtype; dloc and daw
    f32; no gradient into valid_extents)."""

    @staticmethod
    def forward(ctx, src, spatial_shapes, loc, aw, ext):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(src, loc, aw, ext)
        return _raw_pool_fwd(src, spatial_shapes, loc, aw, ext)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_pooled, grad_wsum):
        src, loc, aw, ext = ctx.saved_tensors
        dsrc, dloc, daw = _raw_pool_bwd(
            src, ctx.spatial_shapes, loc, aw, ext,
            grad_pooled.to(src.dtype).contiguous(),
            grad_wsum.float().contiguous(),
        )
        return dsrc, None, dloc, daw, None


def ms_deform_attn_raw_pool(
    src: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    valid_extents: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-then-project pooling of RAW src rows [B, S, C] (pad rows
    zeroed by the caller). Returns (pooled [B, Lq, M, C] in src's dtype,
    wsum [B, Lq, M] float32); the caller projects after pooling and restores
    the projection bias through wsum, exact by linearity:
      sum_k w_k (src_k W + b) = (sum_k w_k src_k) W + (sum_k w_k) b.
    Differentiable in src, sampling_locations and attention_weights.

    valid_extents [B, L, 2] float32 (rows, columns) per level: corners in the
    bottom/right pad region weigh 0 in both outputs, so wsum matches the
    project-first path, which zeroes the projected value, bias included, at
    padded tokens.

    CPU tensors take ``ms_deform_attn_raw_pool_plain``; CUDA tensors go
    through ``MSDeformAttnRawPoolFunction`` (kernels ``msda_raw_pool_fwd`` /
    ``msda_raw_pool_bwd``)."""
    if src.device.type == "cpu":
        return ms_deform_attn_raw_pool_plain(
            src, spatial_shapes, sampling_locations, attention_weights,
            valid_extents,
        )
    if src.device.type != "cuda":
        raise ValueError(
            f"ms_deform_attn_raw_pool runs on cpu or cuda, not {src.device}"
        )
    if src.dim() != 3:
        raise ValueError("src must be [B, S, C]")
    if src.dtype not in _DTYPE_CODE:
        raise TypeError(f"src must be float32 or bfloat16, got {src.dtype}")
    b, s, c = src.shape
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"src has {s} tokens, spatial_shapes {spatial_shapes}")
    _, _, l, _ = _check_samples(
        sampling_locations, attention_weights, b, len(spatial_shapes),
        src.device,
    )
    if valid_extents is not None:
        if (tuple(valid_extents.shape) != (b, l, 2)
                or valid_extents.dtype != torch.float32
                or valid_extents.device != src.device):
            raise ValueError(
                f"valid_extents must be float32 [{b}, {l}, 2] on {src.device}"
            )
        valid_extents = valid_extents.detach().contiguous()
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDeformAttnRawPoolFunction.apply(
        src.contiguous(), shapes, sampling_locations.contiguous(),
        attention_weights.contiguous(), valid_extents,
    )


ms_deform_attn_raw_pool.launches = 0
ms_deform_attn_raw_pool.bwd_launches = 0

