"""kinet_tpu_torch row-gather probe (the port of the Pallas probe kernel
scripts/pallas_gather_probe.py::run): the plain version against
jnp.take_along_axis(tbl, idx, axis=0), the kernel's body, on the same
numpy-seeded inputs (exact: a gather copies values), including negative and
out-of-range indices; the probe's entry point on the CPU; and, where a card
is present, the CUDA kernel against the plain version. The JAX probe script
runs its benchmark when imported, so it is not imported here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu_torch.ops import gather_probe
from kinet_tpu_torch.tools import gather_probe as probe


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
