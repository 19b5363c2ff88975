"""kinet_tpu_torch's reference-checkpoint importer
(``tools/import_torch_weights.py``) against the JAX package's, on the CPU.

For each model family (vanilla DETR, the flagship Deformable DETR with box
refinement, the segmentation wrapper, KineT's dual-stream model) one
synthetic reference state dict goes two ways from the same initial
weights: route 1 is the JAX importer into the flax tree, then the port's
``load_jax_params``; route 2 is the port's importer into the port model.
Both give the same state dict bit for bit and equal reports. Also: the
imported flagship's forward against JAX's at 1e-4, the errors of
``strict``, the cast into a bf16 model, and the command line.
"""
import argparse
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.structs import ImageBatch as JaxImageBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tools.import_torch_weights import import_state_dict as jax_import
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.tools import import_torch_weights as port_import
from kinet_tpu_torch.tools.from_jax import load_jax_params

import test_torch_detr as detr_tests
import test_torch_kine as kine_tests
from _ref_state_dict import reference_state_dict
from test_torch_port_model import (FLAGSHIP, TINY, frame_inputs, jax_inputs,
                                   tiny_params, torch_inputs)

MOTS = ["train_tracking", "train_mots20"]
# the JAX package's own importer test (tests/test_torch_import.py): plain
# DETR without track queries, hidden 32, 2 heads, one layer a side
VANILLA = dict(dataset="mot", backbone="resnet_test", hidden_dim=32,
               nheads=2, enc_layers=1, dec_layers=1, dim_feedforward=32,
               num_queries=4, dropout=0.0, aux_loss=False)


def _vanilla_sd():
    """The reference-named state dict of tests/test_torch_import.py's
    test_full_state_dict_import, drawn the same way."""
    rng = np.random.default_rng(2)
    d = 32

    def t_(shape, positive=False):
        x = rng.normal(size=shape).astype(np.float32)
        return np.abs(x) + 0.5 if positive else x

    sd = {}
    sd["backbone.0.body.conv1.weight"] = t_((64, 3, 7, 7))
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        sd[f"backbone.0.body.bn1.{leaf}"] = t_((64,), positive=leaf == "running_var")
    widths = {1: 64, 2: 128, 3: 256, 4: 512}
    in_ch = {1: 64, 2: 256, 3: 512, 4: 1024}
    for l, w_ in widths.items():
        pre = f"backbone.0.body.layer{l}.0"
        sd[f"{pre}.conv1.weight"] = t_((w_, in_ch[l], 1, 1))
        sd[f"{pre}.conv2.weight"] = t_((w_, w_, 3, 3))
        sd[f"{pre}.conv3.weight"] = t_((w_ * 4, w_, 1, 1))
        sd[f"{pre}.downsample.0.weight"] = t_((w_ * 4, in_ch[l], 1, 1))
        for bn, ch in (("bn1", w_), ("bn2", w_), ("bn3", w_ * 4)):
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                sd[f"{pre}.{bn}.{leaf}"] = t_((ch,), positive=leaf == "running_var")
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{pre}.downsample.1.{leaf}"] = t_((w_ * 4,), positive=leaf == "running_var")
    sd["input_proj.weight"] = t_((d, 2048, 1, 1))
    sd["input_proj.bias"] = t_((d,))
    sd["query_embed.weight"] = t_((4, d))
    sd["class_embed.weight"] = t_((21, d))
    sd["class_embed.bias"] = t_((21,))
    for i in range(3):
        o = 4 if i == 2 else d
        sd[f"bbox_embed.layers.{i}.weight"] = t_((o, d))
        sd[f"bbox_embed.layers.{i}.bias"] = t_((o,))
    for side in ("encoder", "decoder"):
        pre = f"transformer.{side}.layers.0"
        sd[f"{pre}.self_attn.in_proj_weight"] = t_((3 * d, d))
        sd[f"{pre}.self_attn.in_proj_bias"] = t_((3 * d,))
        sd[f"{pre}.self_attn.out_proj.weight"] = t_((d, d))
        sd[f"{pre}.self_attn.out_proj.bias"] = t_((d,))
        sd[f"{pre}.linear1.weight"] = t_((32, d))
        sd[f"{pre}.linear1.bias"] = t_((32,))
        sd[f"{pre}.linear2.weight"] = t_((d, 32))
        sd[f"{pre}.linear2.bias"] = t_((d,))
        for n in range(1, (2 if side == "encoder" else 3) + 1):
            sd[f"{pre}.norm{n}.weight"] = t_((d,))
            sd[f"{pre}.norm{n}.bias"] = t_((d,))
    pre = "transformer.decoder.layers.0.multihead_attn"
    sd[f"{pre}.in_proj_weight"] = t_((3 * d, d))
    sd[f"{pre}.in_proj_bias"] = t_((3 * d,))
    sd[f"{pre}.out_proj.weight"] = t_((d, d))
    sd[f"{pre}.out_proj.bias"] = t_((d,))
    sd["transformer.decoder.norm.weight"] = t_((d,))
    sd["transformer.decoder.norm.bias"] = t_((d,))
    return sd


def _vanilla():
    jcfg = jax_load_config("train.yaml").replace(**VANILLA)
    cfg = load_config("train.yaml").replace(**VANILLA)
    jmodel, _, _ = jax_build_model(jcfg)
    b = JaxImageBatch(images=jnp.zeros((1, 32, 32, 3)),
                      pad_mask=jnp.zeros((1, 32, 32), bool))
    t = JaxTargets.create(jnp.full((1, 2, 4), 0.5), jnp.zeros((1, 2), jnp.int32),
                          jnp.ones((1, 2), bool), num_track_queries=0,
                          hidden_dim=32)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), b, t))
    return cfg, params, 2


def _flagship():
    _, params = tiny_params(seed=0)
    return load_config("train.yaml", named=FLAGSHIP).replace(**TINY), params, 2


def _segm():
    kw = detr_tests.TINY
    jcfg = jax_load_config("train.yaml", named=MOTS).replace(**kw)
    jmodel, _, _ = jax_build_model(jcfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *detr_tests.jax_inputs(*detr_tests.frame(0))))
    return (load_config("train.yaml", named=MOTS).replace(**kw), params,
            int(kw["nheads"]))


def _kine():
    jcfg, cfg = kine_tests.configs("dual-raw")
    jmodel, _, _ = jax_build_model(jcfg)
    e = kine_tests.embed_dim(cfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *kine_tests.jax_kine(*kine_tests.kine_inputs(0, e))))
    return cfg, params, int(cfg.nheads)


FAMILIES = {"detr": _vanilla, "flagship": _flagship, "segm": _segm,
            "kine": _kine}


@pytest.fixture(scope="module")
def family_cache():
    return {}


def family(cache, name):
    """(port config, initial flax params, heads, reference state dict):
    vanilla DETR takes the JAX test's state dict, the others one drawn
    from a numpy seed under the names of a reference checkpoint."""
    if name not in cache:
        cfg, params, heads = FAMILIES[name]()
        if name == "detr":
            sd = _vanilla_sd()
        else:
            sd = {k: v.numpy() for k, v in reference_state_dict(
                port_model(cfg, params), np.random.default_rng(3)).items()}
        cache[name] = cfg, params, heads, sd
    return cache[name]


def port_model(cfg, params, dtype=torch.float32):
    model, _ = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    return model.to(dtype)


def both_routes(cfg, params, heads, sd, strict=True, dtype=torch.float32):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparams, jrep = jax_import(sd, params, nheads=heads, strict=strict)
        model = port_model(cfg, params, dtype)
        _, rep = port_import.import_state_dict(sd, model, nheads=heads,
                                               strict=strict)
    return port_model(cfg, jparams, dtype), jrep, model, rep


def assert_same_bits(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k].view(-1), sb[k].view(-1)), k


def test_reference_names_match_the_jax_fixture(family_cache):
    """The state dict helper writes a vanilla DETR under the names and
    shapes of the JAX package's hand-written fixture."""
    cfg, params, _, sd = family(family_cache, "detr")
    got = reference_state_dict(port_model(cfg, params))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in sd.items()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_import_matches_jax(name, family_cache):
    cfg, params, heads, sd = family(family_cache, name)
    ref, jrep, got, rep = both_routes(cfg, params, heads, sd)
    assert rep == jrep
    assert not rep["unmapped"]
    assert rep["applied"] == len(got.state_dict())  # every tensor written
    assert_same_bits(got, ref)
    # into the model's state dict: a new one, the same tensors
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        base = port_model(cfg, params).state_dict()
        new, rep_sd = port_import.import_state_dict(sd, base, nheads=heads,
                                                    strict=True)
    assert rep_sd == jrep
    for k, v in ref.state_dict().items():
        assert torch.equal(new[k], v), k
    changed = [k for k in base if not torch.equal(base[k], new[k])]
    assert len(changed) > 0.9 * len(base)  # the input stays as it was


def test_imported_flagship_forward_matches_jax(family_cache):
    cfg, params, heads, _ = family(family_cache, "flagship")
    jmodel, _ = tiny_params(seed=0)
    # sane weights to import: another seeded port model, the MSDA
    # offset and attention kernels given N(0, 0.05^2) entries
    src, _ = build_model(cfg, device="cpu", seed=7)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for n, p in src.named_parameters():
            if ("sampling_offsets" in n or "attention_weights" in n) \
                    and n.endswith("weight"):
                p += torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape))
                                      .astype(np.float32))
    sd = {k: v.numpy() for k, v in reference_state_dict(src).items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparams, _ = jax_import(sd, params, nheads=heads, strict=True)
        model = port_model(cfg, params)
        port_import.import_state_dict(sd, model, nheads=heads, strict=True)
    assert_same_bits(model, src)  # the reference names' round trip
    ref = jax.jit(jmodel.apply)(jparams, *jax_inputs(*frame_inputs(0)))
    with torch.no_grad():
        got = model(*torch_inputs(*frame_inputs(0)))
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        assert torch.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)


def _extra_key(sd):
    return {**sd, "transformer.decoder.layers.0.dropout.weight": np.ones(2)}


def _deeper(sd):
    return {**sd, "transformer.decoder.layers.7.linear1.weight":
            sd["transformer.decoder.layers.0.linear1.weight"]}


def _reshaped(sd):
    w = sd["transformer.decoder.layers.0.linear1.weight"]
    return {**sd, "transformer.decoder.layers.0.linear1.weight": w[:-1]}


def _no_class_head(sd):
    return {k: v for k, v in sd.items() if not k.startswith("class_embed.0.")}


@pytest.mark.parametrize("edit,heads,error", [
    (_extra_key, 2, KeyError),      # a reference name nothing reads
    (_deeper, 2, KeyError),         # a layer the model does not have
    (_reshaped, 2, ValueError),     # a shape that disagrees
    (lambda sd: sd, 5, ValueError),  # heads that do not divide the width
])
def test_strict_raises_where_jax_raises(edit, heads, error, family_cache):
    cfg, params, _, sd = family(family_cache, "flagship")
    sd = edit(sd)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for run in (lambda: jax_import(sd, params, nheads=heads, strict=True),
                    lambda: port_import.import_state_dict(
                        sd, port_model(cfg, params), nheads=heads,
                        strict=True)):
            with pytest.raises(error):
                run()
    if heads == 2:  # without strict both skip the same writes
        ref, jrep, got, rep = both_routes(cfg, params, heads, sd, strict=False)
        assert rep == jrep
        assert_same_bits(got, ref)


def test_alternative_targets_under_strict(family_cache):
    """class_embed.0 fills the flagship's class_embed0 (it has no shared
    head); a checkpoint without it leaves a port tensor unwritten, and
    both importers still accept it under strict."""
    cfg, params, heads, sd = family(family_cache, "flagship")
    ref, jrep, got, rep = both_routes(cfg, params, heads, _no_class_head(sd))
    assert rep == jrep and rep["applied"] == len(got.state_dict()) - 2
    assert_same_bits(got, ref)


def test_import_casts_to_the_target_dtype(family_cache):
    cfg, params, heads, sd = family(family_cache, "flagship")
    ref, jrep, got, rep = both_routes(cfg, params, heads, sd,
                                      dtype=torch.bfloat16)
    assert rep == jrep
    assert_same_bits(got, ref)
    assert {p.dtype for p in got.parameters()} == {torch.bfloat16}


def test_cli_writes_a_run_the_tracker_restores(family_cache, tmp_path, capsys):
    """``python -m kinet_tpu_torch.tools.import_torch_weights``: a
    reference .pth ({"model": state dict, "args": its Namespace}, read
    weights-only) into a run directory that engine/track.py restores."""
    from kinet_tpu_torch.config import save_config
    from kinet_tpu_torch.engine.track import restore_model

    cfg, params, heads, sd = family(family_cache, "flagship")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(lr=2e-4, backbone="resnet50")},
               tmp_path / "ref.pth")
    save_config(cfg, tmp_path / "cfg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_import.main([str(tmp_path / "ref.pth"), "--config",
                          str(tmp_path / "cfg" / "config.yaml"), "--strict",
                          "--device", "cpu", "--out", str(tmp_path / "run")])
        ref, _, _, _ = both_routes(cfg, params, heads, sd)
    assert "0 reference keys unmapped" in capsys.readouterr().out
    model, _ = restore_model(str(tmp_path / "run"), torch.device("cpu"))
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
