"""kinet_tpu_torch's data-parallel train step on the CPU (gloo): the
gradient all-reduce of ``engine/train_step.py`` (``all_reduce_grads``)
with the criterion's ``num_boxes`` averaged over the processes.

- 2 processes, each stepping on one image of a batch of 2, against 1
  process stepping on the whole batch: for 3 steps of a tiny
  flagship-family model (deformable, multi-frame, tracking with the
  track-query simulation's false positives and negatives off, so its
  draws keep every matched track whatever the split; the slot order it
  draws changes only the order of sums), the mean over the processes of
  each weighted loss and the total and the gradient norm agree within
  rtol 1e-5, and every parameter after each step within rtol 1e-4, atol
  1e-5 (float32, lr 1e-4; measured here: 2e-7 and 9.4e-7); both processes
  hold the same parameters, bit for bit;
- the 2 processes against 1 process stepping each image on its own (a
  generator each, as each process has) and applying the mean of the two
  gradients: the same arithmetic, so the same losses, gradient norms and
  parameters, bit for bit (chip_smoke.py's phase S makes this check at
  full width on the card, where the concatenated batch's kernels and the
  bilinear sampling's kinks move a gradient by more than rounding);
- 1 process in a group of one against 1 process without a group, both
  on one torch thread: the same losses, gradient norm and parameters,
  bit for bit;
- ``python -m kinet_tpu_torch.tools.launch`` in 2 processes on the CPU
  (gloo, a ``file://`` rendezvous): each trains on its shard of the
  frames (half the steps of one process), and rank 0 alone prints and
  writes the checkpoint;
- a ``mesh.data`` that is not the process count is refused.
"""
import numpy as np
import pytest
import torch

from kinet_tpu_torch.config import load_config

from test_torch_dist import run_processes, write_mot_tree

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=1, dec_layers=1, dim_feedforward=64, num_queries=12,
    max_objects=3, max_track_queries=4, dropout=0.0,
    track_query_false_positive_prob=0.0, track_query_false_negative_prob=0.0,
    compute_dtype="float32",
)
H, W, N_OBJ, N_IMAGES, N_STEPS = 48, 64, 3, 2, 3
LR = 1e-4


def _image(seed):
    """One image's (current, previous) frames: noise with N_OBJ bright
    boxes that move a little between the frames, as numpy arrays."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0.25, 0.75, (N_OBJ, 2))
    out = []
    for shift in (0.0, 0.02):
        img = rng.normal(0, 0.5, (H, W, 3)).astype(np.float32)
        cxcywh = np.concatenate([boxes + shift, np.full((N_OBJ, 2), 0.2)], 1)
        for cx, cy, w, h in cxcywh:
            y0, x0 = int((cy - h / 2) * H), int((cx - w / 2) * W)
            img[y0:y0 + int(h * H), x0:x0 + int(w * W)] += 2.0
        out.append((img, cxcywh.astype(np.float32)))
    return out


def _inputs(seeds, step):
    """(batch, targets, prev_batch, prev_targets) of the images ``seeds``
    at train step ``step``."""
    from kinet_tpu_torch.structs import ImageBatch, Targets

    frames = [_image(1000 * step + s) for s in seeds]
    out = []
    for f in (0, 1):  # current, previous
        imgs = np.stack([fr[f][0] for fr in frames])
        boxes = np.stack([fr[f][1] for fr in frames])
        n = len(seeds)
        targets = Targets.create(
            torch.from_numpy(boxes), torch.zeros(n, N_OBJ, dtype=torch.int64),
            torch.ones(n, N_OBJ, dtype=torch.bool),
            track_ids=torch.arange(N_OBJ).expand(n, N_OBJ).clone(),
            num_track_queries=int(TINY["max_track_queries"]),
            hidden_dim=int(TINY["hidden_dim"]))
        out += [ImageBatch(torch.from_numpy(imgs),
                           torch.zeros(n, H, W, dtype=torch.bool)), targets]
    return out[0], out[1], out[2], out[3]


def _steps(rank, world, tmp, n_steps=N_STEPS):
    """n_steps train steps on this process's share of the images; returns
    (the weighted losses, total and gradient norm of each step, the
    parameters after each step)."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model

    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, lr=LR)
    model, _ = build_model(cfg, device="cpu", seed=0)
    model.train()
    criterion = build_criterion(cfg)
    step = make_train_step(model, criterion, Optimizer(model, cfg, 100), cfg,
                           generator=torch.Generator().manual_seed(5))
    keys = list(criterion.weight_dict) + ["loss", "grad_norm"]
    losses, params = [], []
    for s in range(n_steps):
        got = step(*_inputs(list(range(N_IMAGES))[rank::world], s))
        losses.append({k: float(v) for k, v in got.items() if k in keys})
        params.append({k: v.detach().clone()
                       for k, v in model.named_parameters()})
    return losses, params


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The 2-process run, for the two comparisons below."""
    return run_processes(_steps, 2, tmp_path_factory.mktemp("two"))


def test_two_processes_equal_one_on_the_whole_batch(two, tmp_path):
    (one,) = run_processes(_steps, 1, tmp_path / "one")
    for s in range(N_STEPS):
        ref = one[0][s]
        assert ref["loss"] > 0 and ref["grad_norm"] > 0
        assert "loss_bbox" in ref and "loss_ce" in ref
        for k, v in ref.items():
            # every process's gradient norm is the reduced gradient's
            got = (two[0][0][s][k] if k == "grad_norm" else
                   np.mean([t[0][s][k] for t in two]))
            assert got == pytest.approx(v, rel=1e-5, abs=1e-6), (s, k)
        assert two[0][0][s]["grad_norm"] == two[1][0][s]["grad_norm"]
        for name, p in one[1][s].items():
            a, b = two[0][1][s][name], two[1][1][s][name]
            assert torch.equal(a, b), name  # one update on both
            torch.testing.assert_close(a, p, rtol=1e-4, atol=1e-5, msg=name)


def _split_steps(rank, world, tmp):
    """N_STEPS steps of 1 process stepping each image alone, with a
    generator of its own, and applying the mean of their gradients."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model

    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, lr=LR)
    model, _ = build_model(cfg, device="cpu", seed=0)
    model.train()
    criterion = build_criterion(cfg)
    opt = Optimizer(model, cfg, 100)
    kept = []

    class Keeping:
        params = opt.params
        zero_grad = opt.zero_grad

        def step(self):
            kept.append([torch.zeros_like(p) if p.grad is None else
                         p.grad.clone() for p in opt.params])
            return torch.zeros(())

    steps = [make_train_step(model, criterion, Keeping(), cfg,
                             generator=torch.Generator().manual_seed(5))
             for _ in range(N_IMAGES)]
    keys = list(criterion.weight_dict) + ["loss"]
    losses, params = [], []
    for s in range(N_STEPS):
        outs = [steps[i](*_inputs([i], s)) for i in range(N_IMAGES)]
        for p, g0, g1 in zip(opt.params, *kept):
            p.grad = (g0 + g1) / 2
        kept.clear()
        norm = float(opt.step())
        losses.append([{**{k: float(v) for k, v in o.items() if k in keys},
                        "grad_norm": norm} for o in outs])
        params.append({k: v.detach().clone()
                       for k, v in model.named_parameters()})
    return losses, params


def test_two_processes_equal_one_stepping_each_image(two, tmp_path):
    (split,) = run_processes(_split_steps, 1, tmp_path / "one", group=False)
    for s in range(N_STEPS):
        for r in range(2):
            assert two[r][0][s] == split[0][s][r], (s, r)
            for name, p in split[1][s].items():
                assert torch.equal(two[r][1][s][name], p), (s, r, name)


def test_world1_group_is_bit_identical(tmp_path):
    (grouped,) = run_processes(_steps, 1, tmp_path)
    (alone,) = run_processes(_steps, 1, tmp_path, group=False)
    assert grouped[0] == alone[0]
    for s in range(N_STEPS):
        for name, p in alone[1][s].items():
            assert torch.equal(grouped[1][s][name], p), (s, name)


def test_mesh_data_must_be_the_process_count():
    from kinet_tpu_torch.engine.train import train

    cfg = load_config("train.yaml", named=FLAGSHIP).replace(
        **TINY, **{"mesh.data": 2})
    with pytest.raises(ValueError, match="mesh.data 2"):
        train(cfg, device="cpu")


def test_launcher_trains_in_two_processes(tmp_path):
    import json
    import subprocess
    import sys
    from pathlib import Path

    from kinet_tpu_torch.utils.checkpoint import load_checkpoint

    write_mot_tree(tmp_path / "mot")
    over = dict(TINY, max_objects=6, batch_size=1, epochs=1, num_workers=1,
                val_interval=0, log_interval=1, size_buckets=[[64, 96]],
                **{"img_transform.max_size": 96, "img_transform.val_width": 64})
    argv = ["--device", "cpu", "--coordinator", f"file://{tmp_path}/rdv",
            "--num-hosts", "2", "--config", "train.yaml", "--named",
            *FLAGSHIP, "--", f"mot_path_train={tmp_path / 'mot'}",
            f"mot_path_val={tmp_path / 'mot'}",
            f"output_dir={tmp_path / 'out'}"]
    argv += [f"{k}={json.dumps(v)}" for k, v in over.items()]
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kinet_tpu_torch.tools.launch", *argv[:4],
         "--host-id", str(r), *argv[4:]], cwd=repo, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240))
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1] + outs[1][1]
    assert "Epoch [1]" in outs[0][0] and outs[1][0] == ""
    ckpt = load_checkpoint(tmp_path / "out" / "checkpoint.pth")
    # 4 frames, 2 processes, batch 1: 2 steps each
    assert ckpt["step"] == 2 and ckpt["epoch"] == 1
