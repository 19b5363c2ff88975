"""kinet_tpu_torch row-gather probe (the port of the Pallas probe kernel
scripts/pallas_gather_probe.py::run): the plain version against
jnp.take_along_axis(tbl, idx, axis=0), the kernel's body, on the same
numpy-seeded inputs (exact: a gather copies values), including negative and
out-of-range indices; a numpy model of the kernel's work split (which
block, thread and item takes each element, and its column) against
take_along_axis; the probe's entry point on the CPU; and, where a card is
present, the CUDA kernel against the plain version at odd shapes, on
non-contiguous and unaligned inputs. The JAX probe script runs its
benchmark when imported, so it is not imported here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu_torch.ops import gather_probe
from kinet_tpu_torch.tools import gather_probe as probe


THREADS, ITEMS = 256, 8  # csrc/gather_rows.cu kThreads, kItems


def _cdiv(a, b):
    return -(-a // b)


def _run_model(tbl, idx):
    """The kernel's work split in numpy: block b, thread t, item u take flat
    element b * 2048 + u * 256 + t, the column kept by adding 256 % C from
    one item to the next. Returns the output and how many times each
    element was written."""
    r, c = tbl.shape
    n = r * c
    step = THREADS % c
    flat_idx, flat_tbl = idx.reshape(-1), tbl.reshape(-1)
    out = np.full(n, -7.0, np.float32)
    writes = np.zeros(n, np.int64)
    for b in range(_cdiv(n, THREADS * ITEMS)):
        t0 = b * THREADS * ITEMS + np.arange(THREADS)
        col = t0 % c
        for u in range(ITEMS):
            t = t0 + u * THREADS
            ok = t < n
            assert (col[ok] == t[ok] % c).all()
            row = flat_idx[t[ok]].astype(np.int64)
            row = np.where(row < 0, row + r, row)
            inside = (row >= 0) & (row < r)
            val = flat_tbl[np.clip(row, 0, r - 1) * c + col[ok]]
            out[t[ok]] = np.where(inside, val, np.nan)
            writes[t[ok]] += 1
            col = col + step
            col = np.where(col >= c, col - c, col)
    return out.reshape(r, c), writes.reshape(r, c)


def _inputs(seed, r=64, c=16, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    tbl = rng.normal(size=(r, c)).astype(np.float32)
    idx = rng.integers(lo, r if hi is None else hi, size=(r, c)).astype(np.int32)
    return tbl, idx


@pytest.mark.parametrize("bounds", [(0, None), (-64, 80)])
def test_plain_matches_take_along_axis(bounds):
    tbl, idx = _inputs(0, lo=bounds[0], hi=bounds[1])
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(tbl), jnp.asarray(idx), axis=0))
    out = gather_probe.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


# the probe's shape; a column count under, at and over one block's 256
# threads; a single column; a table of more than 65,536 rows
SHAPES = [(8192, 128), (8193, 13), (1000, 20), (300, 7), (64, 256),
          (523, 300), (3, 1), (57345, 12)]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_model_matches_take_along_axis(shape):
    r = shape[0]
    tbl, idx = _inputs(3, *shape, lo=-r - 5, hi=r + 5)
    out, writes = _run_model(tbl, idx)
    assert (writes == 1).all()
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(tbl), jnp.asarray(idx), axis=0))
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(out, ref)


def test_probe_entry_point_on_cpu(capsys):
    before = gather_probe.gather_rows.launches
    res = probe.main(["--device", "cpu"])
    assert gather_probe.gather_rows.launches == before  # the plain version
    assert res["device"] == "cpu" and res["us_per_op"] > 0
    tbl, idx = probe.probe_inputs("cpu")
    assert tbl.shape == (probe.R, probe.C) and idx.dtype == torch.int32
    assert "GB/s" in capsys.readouterr().out


def test_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run_probe()


def test_gather_rows_checks_its_inputs():
    tbl, idx = _inputs(1)
    with pytest.raises(TypeError):
        gather_probe.gather_rows(torch.from_numpy(tbl),
                                 torch.from_numpy(idx).long())
    with pytest.raises(ValueError):
        gather_probe.gather_rows(torch.from_numpy(tbl),
                                 torch.from_numpy(idx[:-1]))


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    tbl, idx = (torch.from_numpy(x).cuda() for x in _inputs(2, lo=-64, hi=80))
    before = gather_probe.gather_rows.launches
    out = gather_probe.gather_rows(tbl, idx)
    assert gather_probe.gather_rows.launches == before + 1
    ref = gather_probe.gather_rows_plain(tbl, idx)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_at_odd_shapes_on_gpu(shape):
    """Exactly the plain version, NaNs in the same places, one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    r = shape[0]
    tbl, idx = (torch.from_numpy(x).cuda()
                for x in _inputs(4, *shape, lo=-r - 5, hi=r + 5))
    before = gather_probe.gather_rows.launches
    out = gather_probe.gather_rows(tbl, idx)
    assert gather_probe.gather_rows.launches == before + 1
    ref = gather_probe.gather_rows_plain(tbl, idx)
    assert torch.isnan(ref).any()
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_kernel_takes_non_contiguous_and_unaligned_inputs_on_gpu():
    """A transposed view is copied to a contiguous one; a table that is not
    16-byte aligned is gathered as it lies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    tbl, idx = (torch.from_numpy(np.ascontiguousarray(x.T)).cuda().t()
                for x in _inputs(5, 520, 96, lo=-530, hi=530))
    assert not tbl.is_contiguous() and not idx.is_contiguous()
    out = gather_probe.gather_rows(tbl, idx)
    assert out.is_contiguous()
    torch.testing.assert_close(out, gather_probe.gather_rows_plain(tbl, idx),
                               rtol=0, atol=0, equal_nan=True)
    shifted = torch.empty(520 * 96 + 1, device="cuda")[1:].view(520, 96)
    shifted.copy_(tbl)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(gather_probe.gather_rows(shifted, idx),
                               gather_probe.gather_rows_plain(shifted, idx),
                               rtol=0, atol=0, equal_nan=True)
