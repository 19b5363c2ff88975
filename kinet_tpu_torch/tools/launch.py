"""Multi-process launcher (port of ``kinet_tpu/tools/launch.py``;
reference src/run_with_submitit.py): one process per GPU, training or,
with ``--track``, tracking.

    torchrun --nproc-per-node 8 -m kinet_tpu_torch.tools.launch \\
        --config train.yaml --named train_deformable train_tracking -- \\
        mot_path_train=data/MOT17 output_dir=runs/exp1

    python -m kinet_tpu_torch.tools.launch --coordinator host0:29500 \\
        --num-hosts 2 --host-id 0 --gpus-per-host 8 --local-rank 3 ...

Each process joins the default process group, then trains
(``engine/train.py``) on its shard of the data (``mesh.data`` x
``mesh.model`` processes: ``mesh.model`` > 1 shards the model over each
group of that many consecutive ranks, ``parallel/tp.py``), or with
``--track`` runs ``engine/track.py::main_track`` (``--config`` defaults
to ``track.yaml``; ``spatial_parallel=N`` over N processes serves each
frame split over them, ``parallel/sp.py``):
- its coordinates come from ``--coordinator host:port --num-hosts
  --host-id`` with ``--gpus-per-host`` and ``--local-rank`` (rank
  host_id * gpus_per_host + local_rank; ``tools/slurm_launch.py`` passes
  them), else from torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``; with neither it trains alone,
  without a group. ``--coordinator`` also takes an init URL as it stands
  (``tcp://...``, ``file://...``);
- the backend is NCCL on the card, with ``torch.cuda.set_device`` to the
  local rank, and gloo on the CPU (``--device cpu``). NCCL refuses two
  ranks on one card, so a host that runs more processes than it has
  cards is refused unless ``--backend gloo`` asks for processes that
  share the cards (``torch.cuda.set_device`` to the local rank modulo
  the cards);
- it resumes from ``output_dir/checkpoint.pth`` when that exists and no
  ``resume`` is given (the requeue point of a preempted run);
- with ``--requeue-on-preempt`` it installs the SIGTERM / SIGUSR1 handler
  of ``utils/preempt.py``; when ``train`` returns after a preemption it
  re-execs itself, ``python -m kinet_tpu_torch.tools.launch`` with the
  same arguments, which resumes (reference run_with_submitit.py:53-67).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from datetime import timedelta

import torch
import torch.distributed as tdist


def _coordinates(args) -> tuple[str, int, int, int, int] | None:
    """(init method, world size, rank, local rank, processes on this
    host), or None for a run of one process without a group."""
    if args.coordinator:
        url = args.coordinator
        if "://" not in url:
            url = f"tcp://{url}"
        local = (args.local_rank if args.local_rank is not None
                 else int(os.environ.get("LOCAL_RANK", 0)))
        return (url, args.num_hosts * args.gpus_per_host,
                args.host_id * args.gpus_per_host + local, local,
                args.gpus_per_host)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        return ("env://", world, int(os.environ["RANK"]),
                int(os.environ.get("LOCAL_RANK", 0)),
                int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return None


def init_process_group(args) -> None:
    """Joins the default group as the arguments or torchrun's environment
    say; does nothing for a run of one process without coordinates."""
    coords = _coordinates(args)
    if coords is None:
        return
    url, world, rank, local, on_host = coords
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if args.device == "cpu":
        if backend != "gloo":
            raise ValueError(f"--backend {backend} needs the card; on the "
                             f"CPU the backend is gloo")
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device: pass --device cpu to train "
                               "on the CPU")
        if on_host > cards and backend != "gloo":
            raise ValueError(
                f"{on_host} processes a host on {cards} card(s): NCCL takes "
                f"one card a process; pass --backend gloo for processes "
                f"that share the cards")
        torch.cuda.set_device(local % cards)
    tdist.init_process_group(backend, init_method=url, world_size=world,
                             rank=rank, timeout=timedelta(minutes=30))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="kinet_tpu_torch launcher")
    p.add_argument("--config", default=None,
                   help="train.yaml (the default), or track.yaml with "
                        "--track")
    p.add_argument("--track", action="store_true",
                   help="run the tracking entry point (main_track) in the "
                        "group instead of training")
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="the process group's backend: nccl on the card (the "
                        "default), gloo on the CPU or for processes that "
                        "share a card")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0, or an init URL")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--gpus-per-host", type=int, default=1,
                   help="processes a host, one per GPU")
    p.add_argument("--local-rank", type=int, default=None,
                   help="this process's GPU on its host (LOCAL_RANK)")
    p.add_argument("--requeue-on-preempt", action="store_true",
                   help="checkpoint mid-epoch on SIGTERM / SIGUSR1 and "
                        "re-exec this launcher, which resumes")
    p.add_argument("overrides", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns what ``train`` returns: (model, optimizer, step); with
    ``--track`` what ``main_track`` returns (the metrics summary)."""
    from ..config import load_config, parse_cli_overrides
    from ..engine.track import main_track
    from ..engine.train import train
    from ..utils import preempt

    args = parse_args(argv)
    if args.track:
        init_process_group(args)
        try:
            cfg = load_config(args.config or "track.yaml", named=args.named,
                              overrides=parse_cli_overrides(args.overrides))
            if args.device:
                cfg = cfg.replace(device=args.device)
            return main_track(cfg)
        finally:
            if tdist.is_initialized():
                tdist.destroy_process_group()
    if args.requeue_on_preempt:
        preempt.install()
    init_process_group(args)
    try:
        cfg = load_config(args.config or "train.yaml", named=args.named,
                          overrides=parse_cli_overrides(args.overrides))
        latest = osp.join(cfg.output_dir, "checkpoint.pth") \
            if cfg.output_dir else ""
        if latest and not cfg.resume and osp.exists(latest):
            cfg = cfg.replace(resume=latest, resume_optim=True)
            print(f"auto-resuming from {latest}", flush=True)
        result = train(cfg, device=args.device)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    if args.requeue_on_preempt and preempt.requested():
        print("requeueing after preemption", flush=True)
        os.execv(sys.executable,
                 [sys.executable, "-m", "kinet_tpu_torch.tools.launch"]
                 + list(sys.argv[1:] if argv is None else argv))
    return result


if __name__ == "__main__":
    main()
