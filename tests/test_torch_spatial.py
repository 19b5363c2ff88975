"""kinet_tpu_torch's spatially parallel serving (``parallel/sp.py``) on the
CPU, over gloo processes (``test_torch_dist.py::run_processes``): one
frame's rows split over the processes of the group.

One spawn per world size holds every check of that size:

- the halo convolutions and the max pool against the whole op, for each
  (kernel, stride, padding, dilation) the backbone uses (the stem 7x7/s2,
  the 3x3/s2 max pool, the bottleneck's 3x3 at strides 1 and 2, the 1x1/s2
  downsample, DC5's 3x3 at dilation 2, the extra level's 3x3/s2), on row
  splits where a process owns a single output row and at the frame's
  edges (float32, within 1e-5);
- the SP forward of JAX ``tests/test_parallel.py``'s tiny configuration
  (2 processes at 64 x 96; 3 at 128 x 96, blocks of 2, 1 and 1 rows at
  stride 32) against the unsharded port forward and the JAX forward, on
  bridged weights (``tools/from_jax.py``): logits, boxes and the last
  decoder output within atol 2e-5;
- the flagship family (tiny widths: Lite encoder modes, the extra
  stride-64 level, the cached previous memory) over two frames, against
  the unsharded port forward, within atol 2e-5; on 2 processes also
  vanilla DETR and the flagship's mask head, whose trunk alone is split
  (the rest on the gathered features), masks included;
- 2 processes: a 3-frame ``Tracker`` session with ``spatial_group`` gives
  the track ids, frames and rows of one process's session, boxes within
  atol 1e-4 and scores within 1e-5 (JAX ``test_parallel.py:205-213``), on
  both processes; ``main_track`` with ``spatial_parallel: 2`` writes (rank
  0 alone) the MOT rows of one process's run, boxes within 1e-3 px, and
  returns its metrics on both; ``batch_sequences`` > 1 is refused;
- ``spatial_parallel`` other than the process count is refused;
- ``tools/launch.py --track`` in 2 processes with ``spatial_parallel=2``
  over a saved run: rank 0 writes one process's MOT rows and prints.
"""
import csv
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_dist import run_processes, write_sequence

# JAX tests/test_parallel.py:61,124,216
JAX_TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    enc_layers=1, dec_layers=1, dim_feedforward=64, num_queries=8,
    max_track_queries=8, dropout=0.0, aux_loss=False,
    num_feature_levels=2, dec_n_points=2, enc_n_points=2,
    with_box_refine=False,
)
JAX_NAMED = ["train_deformable", "train_tracking"]
FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
FLAG_TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=64, num_queries=12,
    max_track_queries=4, dropout=0.0,
)
HW = {2: (64, 96), 3: (128, 96)}  # stride 32: 2 and 4 rows
FLAG_HW = {2: (128, 96), 3: (192, 96)}  # stride 64: 2 and 3 rows
KEYS = ("pred_logits", "pred_boxes", "hs_embed")
# (kernel, stride, padding, dilation, max pool) of the backbone's ops
HALO_OPS = [(7, 2, 3, 1, False), (3, 2, 1, 1, True), (3, 1, 1, 1, False),
            (3, 2, 1, 1, False), (1, 2, 0, 1, False), (3, 1, 2, 2, False)]


def _frame(seed, h, w, t_slots, hidden):
    rng = np.random.default_rng(100 + seed)
    images = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    pad = np.zeros((1, h, w), bool)
    pad[:, h - 16:] = True  # a bottom band and a right band of padding
    pad[:, :, w - 8:] = True
    return dict(images=images, pad=pad,
                tq_embeds=rng.normal(size=(1, t_slots, hidden)).astype(
                    np.float32),
                tq_boxes=rng.uniform(0.2, 0.6, (1, t_slots, 4)).astype(
                    np.float32),
                tq_mask=(np.arange(t_slots) % 3 != 1)[None])


def _torch_inputs(f):
    from kinet_tpu_torch.structs import ImageBatch, Targets

    t_slots, hidden = f["tq_embeds"].shape[1:]
    targets = Targets.create(
        torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.zeros(1, 1),
        num_track_queries=t_slots, hidden_dim=hidden,
    ).replace(track_query_embeds=torch.from_numpy(f["tq_embeds"]),
              track_query_boxes=torch.from_numpy(f["tq_boxes"]),
              track_query_mask=torch.from_numpy(f["tq_mask"]))
    return (ImageBatch(torch.from_numpy(f["images"]),
                       torch.from_numpy(f["pad"])), targets)


def _port_model(named, tiny, params=None, seed=0):
    from kinet_tpu_torch.config import load_config
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.tools.from_jax import load_jax_params

    cfg = load_config("train.yaml", named=named).replace(**tiny)
    model, post = build_model(cfg, device="cpu", seed=seed)
    if params is not None:
        load_jax_params(model, params)
    return model.eval(), post, cfg


def _forward(model, frames, spatial_of=None, keys=KEYS):
    """The model over ``frames``, each after the first with the previous
    one's cached memory; ``spatial_of(height)`` gives the split. Each
    output of a deformable model also counts the queries of the first
    encoder layer's MSDA."""
    outs, prev = [], None
    queries = []
    encoder = model.transformer.encoder
    hook = encoder.layer0.self_attn.register_forward_pre_hook(
        lambda m, args: queries.append(args[0].shape[1])) \
        if hasattr(encoder, "layer0") else None
    with torch.no_grad():
        for f in frames:
            kw = {}
            if prev is not None and "frame_memory" in prev:
                kw = dict(prev_memory=prev["frame_memory"],
                          pos_cache=prev["pos_cache"])
            if spatial_of is not None:
                kw["spatial"] = spatial_of(f["images"].shape[1])
            prev = model(*_torch_inputs(f), **kw)
            outs.append({k: prev[k].numpy().copy() for k in keys})
            if hook is not None:
                outs[-1]["queries"] = queries.pop()
    if hook is not None:
        hook.remove()
    return outs


def _jax_params(h, w):
    """The JAX tiny model's params (numpy; MSDA offset and weight kernels
    perturbed so the samples depend on the query) and its forward outputs
    on the frame of size h x w."""
    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu.models.build import build_model as jax_build_model
    from kinet_tpu.structs import ImageBatch as JaxImageBatch
    from kinet_tpu.structs import Targets as JaxTargets

    cfg = jax_load_config("train.yaml", named=JAX_NAMED).replace(**JAX_TINY)
    model, _, _ = jax_build_model(cfg)
    f = _frame(0, h, w, 8, 32)
    batch = JaxImageBatch(images=jnp.asarray(f["images"]),
                          pad_mask=jnp.asarray(f["pad"]))
    targets = JaxTargets.create(
        jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32),
        jnp.zeros((1, 1), bool), num_track_queries=8, hidden_dim=32,
    ).replace(track_query_embeds=jnp.asarray(f["tq_embeds"]),
              track_query_boxes=jnp.asarray(f["tq_boxes"]),
              track_query_mask=jnp.asarray(f["tq_mask"]))
    params = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(1), batch, targets))
    rng = np.random.default_rng(1)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if (("sampling_offsets" in key or "attention_weights" in key)
                and "kernel" in key):
            return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    out = jax.jit(lambda p, b, t: model.apply(p, b, t, deterministic=True))(
        params, batch, targets)
    return params, f, {k: np.asarray(out[k]) for k in KEYS}


# ---------------------------------------------------------------------------
# the spawned processes


def _halo_errors(group, rank):
    """Max error of each halo op against the whole op, over row splits
    where a process owns one output row."""
    from kinet_tpu_torch.parallel.sp import SpatialParallel

    errs = []
    g = torch.Generator().manual_seed(7)
    for k, st, p, d, pool in HALO_OPS:
        for height in (4 * st - 1, 6 * st, 5 * st):
            sp = SpatialParallel(height, st, group)
            x = torch.randn(2, 3, height, 9, generator=g)
            if pool:
                op = torch.nn.MaxPool2d(k, st, p)
                got = sp.max_pool(op, x[:, :, slice(*sp.own(1))], 1)
            else:
                op = torch.nn.Conv2d(3, 4, k, st, p, d)
                with torch.no_grad():
                    op.weight.normal_(generator=g)
                    op.bias.normal_(generator=g)
                got = sp.conv(op, x[:, :, slice(*sp.own(1))], 1)
            with torch.no_grad():
                want = op(x)[:, :, slice(*sp.own(st))]
                errs.append(((k, st, p, d, pool, height), sp.own(st),
                             float((got - want).abs().max())
                             if want.numel() else 0.0,
                             tuple(got.shape) == tuple(want.shape)))
    # a group norm over the split level
    sp = SpatialParallel(6, 1, group)
    gn = torch.nn.GroupNorm(2, 4)
    with torch.no_grad():
        gn.weight.normal_(generator=g)
        gn.bias.normal_(generator=g)
        x = torch.randn(2, 4, 6, 5, generator=g) * 3 + 1
        got = sp.group_norm(gn, x[:, :, slice(*sp.own(1))])
        want = gn(x)[:, :, slice(*sp.own(1))]
    errs.append(("group_norm", sp.own(1), float((got - want).abs().max()),
                 True))
    return errs


def _spatial(rank, world, tmp):
    import torch.distributed as tdist

    from kinet_tpu_torch.parallel.sp import spatial_parallel

    group = tdist.group.WORLD
    with open(f"{tmp}/case{world}.pkl", "rb") as f:
        case = pickle.load(f)
    out = {"halo": _halo_errors(group, rank)}
    model, _, _ = _port_model(JAX_NAMED, JAX_TINY, case["params"])
    out["jax_tiny"] = _forward(
        model, [case["frame"]],
        lambda h: spatial_parallel(model, group, h))[0]
    flag, _, _ = _port_model(FLAGSHIP, FLAG_TINY)
    out["flagship"] = _forward(
        flag, case["flag_frames"], lambda h: spatial_parallel(flag, group, h))
    if world == 2:
        for name, (model, frame) in _gathered_models(case).items():
            out[name] = _forward(model, [frame], lambda h: spatial_parallel(
                model, group, h), GATHERED_KEYS[name])[0]
        out["session"] = _session(group)
        out["track"] = _main_track(tmp, "sp", spatial=2)
        try:
            _main_track(tmp, "refused", spatial=2, batch_sequences=2)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    return out


GATHERED_KEYS = {"detr": KEYS, "masks": KEYS + ("pred_masks",)}


def _gathered_models(case):
    """The models whose trunk alone is split (the rest runs on the
    gathered features): vanilla DETR, and the flagship's mask head (its
    deformable encoder split as above), each with its frame."""
    detr, _, _ = _port_model(["train_tracking"], dict(
        dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
        enc_layers=1, dec_layers=1, dim_feedforward=64, num_queries=8,
        max_track_queries=4, dropout=0.0))
    masks, _, _ = _port_model(FLAGSHIP, dict(FLAG_TINY, masks=True))
    return {"detr": (detr, case["detr_frame"]),
            "masks": (masks, case["flag_frames"][0])}


# ---------------------------------------------------------------------------
# the tracker session and main_track


def _session(group=None):
    """JAX test_parallel.py's 3-frame session: every spawn deterministic
    (the class-0 logit pushed up), thresholds at 0.005."""
    from kinet_tpu_torch.tracking.tracker import Tracker

    model, post, _ = _port_model(JAX_NAMED, JAX_TINY, seed=1)
    with torch.no_grad():
        model.class_embed.bias[0] = 2.0
    tracker_cfg = dict(
        detection_obj_score_thresh=0.005, track_obj_score_thresh=0.005,
        detection_nms_thresh=0.9, track_nms_thresh=0.9,
        public_detections=False, inactive_patience=-1,
        reid_sim_threshold=0.0, reid_sim_only=False,
        reid_score_thresh=0.005, reid_greedy_matching=False,
        prev_frame_dist=1, steps_termination=1,
    )
    t = Tracker(model, post["bbox"], tracker_cfg, num_object_queries=8,
                num_track_slots=8, hidden_dim=32, spatial_group=group)
    rng = np.random.default_rng(10)
    for _ in range(3):
        t.step({"images": rng.normal(size=(1, 64, 96, 3)).astype(np.float32),
                "pad_mask": np.zeros((1, 64, 96), bool),
                "orig_size": (128, 192), "dets": np.zeros((0, 4), np.float32)})
    return t.get_results()


SEQ = "MOT17-02-FRCNN"


def _main_track_model():
    """The flagship at tiny widths, its class heads biased to class 0."""
    model, post, cfg = _port_model(FLAGSHIP, dict(
        FLAG_TINY, **{"img_transform.max_size": 160,
                      "img_transform.val_width": 96}))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "class_embed" in name and name.endswith("bias"):
                p.fill_(-4.0)
                p[0] = -1.0
    return model, post, cfg


def _main_track(tmp, out, spatial=0, batch_sequences=1):
    from kinet_tpu_torch.config import load_config
    from kinet_tpu_torch.engine.track import main_track

    model, _, cfg = _main_track_model()
    track_cfg = load_config("track.yaml").replace(
        data_root_dir=f"{tmp}/data", dataset_name=SEQ,
        output_dir=f"{tmp}/{out}", device="cpu", spatial_parallel=spatial,
        batch_sequences=batch_sequences,
        **{"tracker_cfg.detection_obj_score_thresh": 0.25,
           "tracker_cfg.track_obj_score_thresh": 0.2})
    return main_track(track_cfg, obj_detector_model=(model, None, cfg))


def _mot_rows(path):
    with open(path) as f:
        return [[float(v) for v in row] for row in csv.reader(f)]


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per world size: the inputs (pickled for the processes), the JAX and
    unsharded port outputs, and the processes' outputs."""
    tmp = tmp_path_factory.mktemp("spatial")
    write_sequence(tmp / "data", SEQ, n_frames=4, h=96, w=128)
    out = {}
    for world in (2, 3):
        params, frame, jax_out = _jax_params(*HW[world])
        flag_frames = [_frame(s, *FLAG_HW[world], 4, 36) for s in (1, 2)]
        case = {"params": params, "frame": frame, "flag_frames": flag_frames,
                "detr_frame": _frame(3, *HW[world], 4, 32)}
        with open(tmp / f"case{world}.pkl", "wb") as f:
            pickle.dump(case, f)
        model, _, _ = _port_model(JAX_NAMED, JAX_TINY, params)
        flag, _, _ = _port_model(FLAGSHIP, FLAG_TINY)
        out[world] = dict(
            jax=jax_out, port=_forward(model, [frame])[0],
            flag=_forward(flag, flag_frames),
            got=run_processes(_spatial, world, tmp))
        if world == 2:
            out[world].update({
                name: _forward(m, [f], keys=GATHERED_KEYS[name])[0]
                for name, (m, f) in _gathered_models(case).items()})
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_halo_ops_equal_the_whole_op(cases, world):
    got = cases[world]["got"]
    n_single = 0
    for rank in range(world):
        for what, rows, err, same_shape in got[rank]["halo"]:
            assert same_shape, (rank, what)
            assert err <= 1e-5, (rank, what, rows, err)
            n_single += rows[1] - rows[0] == 1
    assert n_single > 0  # some process owned a single output row


@pytest.mark.parametrize("world", [2, 3])
def test_spatial_forward_equals_port_and_jax(cases, world):
    c = cases[world]
    assert sum(c["got"][r]["jax_tiny"]["queries"]
               for r in range(world)) == c["port"]["queries"]
    for rank in range(world):
        got = c["got"][rank]["jax_tiny"]
        for k in KEYS:
            np.testing.assert_allclose(got[k], c["port"][k], atol=2e-5,
                                       rtol=0, err_msg=f"{rank} {k} port")
            np.testing.assert_allclose(got[k], c["jax"][k], atol=2e-5,
                                       rtol=0, err_msg=f"{rank} {k} jax")
        # the encoder's queries were this process's share of the tokens
        assert 0 < got["queries"] < c["port"]["queries"]
        for f, (a, b) in enumerate(zip(c["got"][rank]["flagship"],
                                       c["flag"])):
            assert 0 < a["queries"] < b["queries"]
            for k in KEYS:
                np.testing.assert_allclose(
                    a[k], b[k], atol=2e-5, rtol=0,
                    err_msg=f"flagship frame {f} rank {rank} {k}")


@pytest.mark.parametrize("name", ["detr", "masks"])
def test_spatial_gathered_trunk_equals_port(cases, name):
    """Vanilla DETR and the mask head on the gathered trunk, 2 processes:
    their outputs (masks included) within atol 2e-5 of one process's."""
    for rank in range(2):
        got = cases[2]["got"][rank][name]
        for k in GATHERED_KEYS[name]:
            np.testing.assert_allclose(got[k], cases[2][name][k], atol=2e-5,
                                       rtol=0, err_msg=f"{name} {rank} {k}")


def test_spatial_tracker_session_equals_one_process(cases):
    ref = _session()
    assert ref, "no tracks spawned"
    for rank in range(2):
        got = cases[2]["got"][rank]["session"]
        assert set(got) == set(ref)
        for tid in ref:
            assert set(got[tid]) == set(ref[tid])
            for frame in ref[tid]:
                a, b = got[tid][frame], ref[tid][frame]
                assert a["obj_ind"] == b["obj_ind"]
                np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-4)
                np.testing.assert_allclose(a["score"], b["score"], atol=1e-5)


@pytest.fixture(scope="module")
def one_process(cases):
    """main_track in this process, without a group: its summary (the
    result file under tmp/one)."""
    return _main_track(cases["tmp"], "one")


def test_spatial_main_track_equals_one_process(cases, one_process):
    tmp = cases["tmp"]
    ref = one_process
    assert ref[SEQ]["num_false_positives"] > 0
    for rank in range(2):
        got = cases[2]["got"][rank]["track"]
        assert got.keys() == ref.keys()
        for seq, row in ref.items():
            for k, v in row.items():
                assert got[seq][k] == pytest.approx(v, rel=1e-6, abs=1e-9), (
                    seq, k)
    want = _mot_rows(tmp / "one" / SEQ / f"{SEQ}.txt")
    rows = _mot_rows(tmp / "sp" / SEQ / f"{SEQ}.txt")
    assert want and len(rows) == len(want)
    for a, b in zip(rows, want):
        assert a[:2] == b[:2] and a[6:] == b[6:]
        np.testing.assert_allclose(a[2:6], b[2:6], atol=1e-3)
    assert "batch_sequences" in cases[2]["got"][0]["refused"]


def test_spatial_parallel_must_be_the_process_count(tmp_path):
    write_sequence(tmp_path / "data", SEQ, n_frames=1, h=96, w=128)
    with pytest.raises(ValueError, match="spatial_parallel 2 needs 2"):
        _main_track(tmp_path, "out", spatial=2)


def test_launcher_tracks_spatially_parallel(cases, one_process, tmp_path):
    """``python -m kinet_tpu_torch.tools.launch --track`` in 2 processes
    (gloo on the CPU) with ``spatial_parallel=2``, over a saved run of the
    same weights: rank 0 writes the MOT rows of one process's run (boxes
    within 1e-3 px) and prints the metrics; rank 1 prints nothing."""
    import subprocess
    import sys
    from pathlib import Path

    from kinet_tpu_torch.config import save_config
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    model, _, cfg = _main_track_model()
    save_config(cfg, tmp_path / "run")
    CheckpointManager(str(tmp_path / "run")).save_epoch(
        model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
    argv = ["--track", "--device", "cpu", "--coordinator",
            f"file://{tmp_path}/rdv", "--num-hosts", "2", "--",
            f"obj_detect_checkpoint_dir={tmp_path / 'run'}",
            f"data_root_dir={cases['tmp'] / 'data'}", f"dataset_name={SEQ}",
            f"output_dir={tmp_path / 'out'}", "spatial_parallel=2",
            "tracker_cfg.detection_obj_score_thresh=0.25",
            "tracker_cfg.track_obj_score_thresh=0.2"]
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kinet_tpu_torch.tools.launch",
         "--host-id", str(r), *argv], cwd=repo, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=240))
        finally:
            proc.kill()
    assert [proc.returncode for proc in procs] == [0, 0], \
        outs[0][1] + outs[1][1]
    assert "mota" in outs[0][0] and "mota" not in outs[1][0]
    want = _mot_rows(cases["tmp"] / "one" / SEQ / f"{SEQ}.txt")
    rows = _mot_rows(tmp_path / "out" / SEQ / f"{SEQ}.txt")
    assert want and len(rows) == len(want)
    for a, b in zip(rows, want):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(a[2:6], b[2:6], atol=1e-3)
    assert one_process[SEQ]["num_false_positives"] > 0
