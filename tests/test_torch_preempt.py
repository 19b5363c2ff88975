"""kinet_tpu_torch's preemption path, launcher and SLURM script on the CPU
(the port's version of tests/test_train_e2e.py:160-190 and
tests/test_slurm_launch.py):

- with the preemption flag up, ``train`` stops after one step and writes
  ``checkpoint.pth`` recorded as epoch 0, so the resumed run runs epoch 1
  again (``CheckpointManager.save_preempt``);
- ``tools/launch.py`` resumes from ``output_dir/checkpoint.pth`` by itself;
- the launcher's backend: gloo on the CPU, NCCL on the card with one card
  a process; more processes than cards on a host, or no card, are refused
  unless ``--backend gloo`` asks for processes that share the cards;
- end to end: the launcher with ``--requeue-on-preempt`` gets SIGUSR1
  after its first step, checkpoints, re-execs itself
  (``python -m kinet_tpu_torch.tools.launch``), resumes and finishes the
  run;
- ``tools/slurm_launch.py --dry-run``: an sbatch script of one task per
  GPU with the scheduler's settings, the preemption signal, the requeue
  and the launcher's coordinates; valid bash; a submit config's defaults
  under the flags; the module's command line.
"""
import contextlib
import io
import json
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from kinet_tpu_torch.engine.train import train
from kinet_tpu_torch.tools import launch, slurm_launch
from kinet_tpu_torch.utils import preempt
from kinet_tpu_torch.utils.checkpoint import load_checkpoint

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_entry import FLAGSHIP, TINY, _cfg, mot_root  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# three steps an epoch over the six frames
RUN = dict(TINY, debug=False, epochs=2, batch_size=2, dropout=0.0)


def test_preemption_checkpoints_and_returns(mot_root, tmp_path):
    out = tmp_path / "out"
    prev = preempt.install()
    preempt.request()  # before the loop: it stops after its first step
    try:
        model, optimizer, steps = train(_cfg(mot_root, out, **RUN),
                                        device="cpu")
    finally:
        preempt.clear()
        for s, h in prev.items():
            signal.signal(s, h)
    assert steps == 1 and optimizer.num_updates == 1
    ckpt = load_checkpoint(out / "checkpoint.pth")
    assert ckpt["epoch"] == 0 and ckpt["step"] == 1
    assert not list(out.glob("checkpoint_epoch_*.pth"))


def _argv(mot_root, out, **over):
    run = dict(RUN, **over)
    return (["--device", "cpu", "--config", "train.yaml", "--named",
             *FLAGSHIP, "--", f"mot_path_train={mot_root}",
             f"mot_path_val={mot_root}", f"output_dir={out}"]
            + [f"{k}={json.dumps(v)}" for k, v in run.items()])


def test_launcher_resumes_from_the_run_checkpoint(mot_root, tmp_path, capsys):
    out = tmp_path / "out"
    _, _, steps = launch.main(_argv(mot_root, out, epochs=1))
    assert load_checkpoint(out / "checkpoint.pth")["epoch"] == 1
    _, opt, steps2 = launch.main(_argv(mot_root, out, epochs=2))
    assert "auto-resuming from" in capsys.readouterr().out
    assert steps2 == 2 * steps and opt.num_updates == 2 * steps
    assert load_checkpoint(out / "checkpoint.pth")["epoch"] == 2


# the launcher as its command line runs it, with SIGUSR1 sent to itself
# after the first train step
PREEMPTED = """
import os, signal, sys
from kinet_tpu_torch.engine import train_step
from kinet_tpu_torch.tools import launch
make = train_step.make_train_step
def make_signalling(*a, **kw):
    step = make(*a, **kw)
    def signalling(*b, **kwb):
        out = step(*b, **kwb)
        os.kill(os.getpid(), signal.SIGUSR1)
        return out
    return signalling
train_step.make_train_step = make_signalling
launch.main(sys.argv[1:])
"""


def test_sigusr1_checkpoints_requeues_and_resumes(mot_root, tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-c", PREEMPTED, "--requeue-on-preempt",
         *_argv(mot_root, out, epochs=1)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    text = proc.stdout
    assert proc.returncode == 0, text[-3000:] + proc.stderr[-3000:]
    assert "preemption requested: checkpoint saved at step 1" in text
    assert "requeueing after preemption" in text
    assert f"auto-resuming from {out / 'checkpoint.pth'}" in text
    ckpt = load_checkpoint(out / "checkpoint.pth")
    # the preempted epoch 1 ran again in full: 1 + 3 steps
    assert ckpt["epoch"] == 1 and ckpt["step"] == 4


def _script(*extra):
    argv = ["--dry-run", "--partition", "h100", "--nodes", "4",
            "--gpus-per-node", "8", "--time", "720", "--mem", "512",
            "--job-name", "kinet-mot17", "--constraint", "h100",
            "--comment", "mot17 run", "--config", "train.yaml", "--named",
            "train_deformable", "train_tracking", *extra, "--", "lr=1e-4"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert slurm_launch.main(argv) == 0
    return buf.getvalue()


def test_sbatch_script_contents():
    s = _script()
    for line in ("#SBATCH --partition=h100", "#SBATCH --nodes=4",
                 "#SBATCH --ntasks-per-node=8", "#SBATCH --gpus-per-node=8",
                 "#SBATCH --mem=512G", "#SBATCH --time=720",
                 "#SBATCH --constraint=h100", "#SBATCH --requeue",
                 "#SBATCH --signal=USR1@60"):
        assert line in s, line
    assert "scontrol show hostnames" in s
    assert "-m kinet_tpu_torch.tools.launch" in s
    for arg in ("--num-hosts 4", '--host-id "$SLURM_NODEID"',
                "--gpus-per-host 8", '--local-rank "$SLURM_LOCALID"',
                "--requeue-on-preempt",
                "--named train_deformable train_tracking -- lr=1e-4"):
        assert arg in s, arg
    proc = subprocess.run(["bash", "-n", "/dev/stdin"], input=s, text=True,
                          capture_output=True)
    assert proc.returncode == 0, proc.stderr


def test_submit_config_defaults(tmp_path):
    cfg = tmp_path / "submit.yaml"
    cfg.write_text("partition: pool9\nsignal_delay: 120\nnodes: 8\n"
                   "gpus_per_node: 4\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert slurm_launch.main(["--dry-run", "--submit-config", str(cfg),
                                  "--nodes", "2"]) == 0
    s = buf.getvalue()
    assert "#SBATCH --partition=pool9" in s  # the file's default
    assert "--signal=USR1@120" in s and "#SBATCH --gpus-per-node=4" in s
    assert "#SBATCH --nodes=2" in s  # the flag beats the file
    s = _script("--submit-config", str(REPO / "cfgs" / "submit.yaml"))
    assert "#SBATCH --partition=h100" in s
    bad = tmp_path / "bad.yaml"
    bad.write_text("num_tpus: 4\n")
    with pytest.raises(SystemExit):
        slurm_launch.main(["--dry-run", "--submit-config", str(bad)])


def test_slurm_launch_command_line_dry_run():
    proc = subprocess.run(
        [sys.executable, "-m", "kinet_tpu_torch.tools.slurm_launch",
         "--dry-run", "--nodes", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "#SBATCH --nodes=2" in proc.stdout


@pytest.mark.parametrize("device, backend, cards, on_host, local, want", [
    ("cpu", None, 0, 2, 1, ("gloo", None)),
    ("cpu", "nccl", 0, 1, 0, "needs the card"),
    (None, None, 2, 2, 1, ("nccl", 1)),
    (None, None, 1, 2, 1, "pass --backend gloo"),
    (None, "gloo", 1, 2, 1, ("gloo", 0)),
    (None, None, 0, 1, 0, "no CUDA device"),
])
def test_launcher_backend(monkeypatch, device, backend, cards, on_host,
                          local, want):
    """The backend and card ``init_process_group`` picks from torchrun's
    environment, or the error it raises, with the group's start and the
    card's selection recorded instead of made."""
    import torch
    import torch.distributed as tdist

    made = {}
    monkeypatch.setenv("RANK", str(local))
    monkeypatch.setenv("WORLD_SIZE", str(on_host))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(on_host))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: made.setdefault("card", i))
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda b, **kw: made.setdefault("backend", b))
    argv = (["--device", device] if device else []) + (
        ["--backend", backend] if backend else [])
    args = launch.parse_args(argv)
    if isinstance(want, str):
        with pytest.raises((ValueError, RuntimeError), match=want):
            launch.init_process_group(args)
        assert "backend" not in made
    else:
        launch.init_process_group(args)
        assert (made["backend"], made.get("card")) == want
