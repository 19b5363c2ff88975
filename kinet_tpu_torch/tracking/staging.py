"""The copy of a step's staged inputs to the device (the tracer's ``h2d``).

A served step copies each stream's frame (a 1080x1920 float32 frame is
24.9 MB) and its track-query slots to the device. A pageable copy of that
blocks the host until it lands, and runs at a fraction of the link's
rate. ``FrameStager`` instead:

- fills one reusable host buffer per staged array, ``[B, ...]``, page-locked
  where the device is CUDA, allocated at the first step of a shape and
  dtype and reused after (a new shape or dtype allocates again);
- writes the images in the dtype the model casts them to first
  (``model.image_dtype``): bf16 under the served configs, which halves the
  bytes on the link. The CPU's conversion rounds to nearest even, as the
  device's cast does, so the backbone reads the same bits;
- fills the frames (images and pad mask, ``[B, H, W, ...]``) in parallel.
  Where torch runs its own operations on one thread (as the benchmark sets
  it), a piece a row, up to a core less one, a piece a worker of a thread
  pool (``Tensor.copy_`` releases the interpreter lock); the stepping
  thread copies each piece to the device as soon as it is filled, so the
  copy of one piece runs while later pieces are filled. Where torch has
  more threads (its default, one a core), one piece, which ``copy_``
  splits over them itself: workers of a pool would each split theirs too
  and crowd the cores. The small arrays (the track-query slots, the size)
  go whole, one copy each;
- copies into device tensors allocated anew each step, so nothing that a
  step keeps (a pad mask in the frame's features) is overwritten by the
  next, and records an event after the copies that the next step waits on
  before it writes a buffer again.

Counters (``utils/trace.py``): ``h2d_bytes`` the host arrays' bytes as
given, ``h2d_pinned_bytes`` the bytes copied from page-locked buffers (0
on a CPU device), ``h2d_stage_allocs`` the buffers allocated.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor, wait

import torch

from ..utils import trace

IMAGES = "images"
FRAME = (IMAGES, "pad_mask")  # [B, H, W, ...]: filled and copied in pieces


def workers() -> int:
    """The most pieces the pool fills at once: a core each, less the one the
    stepping thread keeps to copy the pieces and enqueue the forward."""
    return max(1, len(os.sched_getaffinity(0)) - 1)


class FrameStager:
    def __init__(self, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self._bufs = {}  # name -> the host buffer [B, ...]
        self._copied = None  # an event after the last step's copies
        self._pool = None

    def _buffer(self, name, shape, dtype):
        buf = self._bufs.get(name)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self.pinned)
            self._bufs[name] = buf
            trace.count("h2d_stage_allocs")
        return buf

    def stage(self, parts: list, image_dtype: torch.dtype) -> dict:
        """{name: device tensor [B, ...]}: the parts' host numpy arrays
        (dicts of like names, each array [b, ...]) concatenated on the
        batch axis in order, the images in ``image_dtype``."""
        offsets = [0]
        for p in parts:
            offsets.append(offsets[-1] + len(p[IMAGES]))
        if trace.enabled():
            trace.count("h2d_bytes", sum(a.nbytes for p in parts
                                         for a in p.values()))
        if self._copied is not None:
            self._copied.synchronize()  # the buffers' last copies are done
        bufs = {}
        for name, a in parts[0].items():
            dtype = image_dtype if name == IMAGES else torch.from_numpy(a).dtype
            bufs[name] = self._buffer(name, (offsets[-1], *a.shape[1:]), dtype)
        out = {name: torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
               for name, buf in bufs.items()}

        # the frames as [B * H, W, ...]: a piece is a run of those rows,
        # which may span rows of the batch and parts; part j holds rows
        # offsets[j] * H onwards
        h = bufs[IMAGES].shape[1]
        src = {name: [torch.from_numpy(p[name]).flatten(0, 1) for p in parts]
               for name in FRAME}
        host = {name: bufs[name].flatten(0, 1) for name in FRAME}
        dev = {name: out[name].flatten(0, 1) for name in FRAME}
        rows = offsets[-1] * h
        n = min(workers(), offsets[-1]) if torch.get_num_threads() == 1 else 1
        cuts = [k * rows // n for k in range(n + 1)]

        def fill(k):
            for j in range(len(parts)):
                base = offsets[j] * h
                lo, hi = max(cuts[k], base), min(cuts[k + 1], offsets[j + 1] * h)
                if lo < hi:
                    for name in FRAME:
                        host[name][lo:hi].copy_(src[name][j][lo - base:hi - base])

        def copy(dst, buf):
            dst.copy_(buf, non_blocking=self.pinned)

        filled = []
        if n > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(workers())
            filled = [self._pool.submit(fill, k) for k in range(n)]
        try:
            small = [name for name in bufs if name not in FRAME]
            for name in small:  # while the workers fill the frames
                for j, p in enumerate(parts):
                    bufs[name][offsets[j]:offsets[j + 1]].copy_(
                        torch.from_numpy(p[name]))
            for k in range(n):
                if filled:
                    filled[k].result()
                else:
                    fill(k)
                lo, hi = cuts[k], cuts[k + 1]
                for name in FRAME:
                    copy(dev[name][lo:hi], host[name][lo:hi])
        finally:  # no worker writes a buffer once this returns
            wait(filled)
        for name in small:
            copy(out[name], bufs[name])
        if self.pinned:
            trace.count("h2d_pinned_bytes", sum(
                b.numel() * b.element_size() for b in bufs.values()))
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        return out
