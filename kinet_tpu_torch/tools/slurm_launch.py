"""SLURM binding for multi-GPU training (port of
``kinet_tpu/tools/slurm_launch.py``; reference
src/run_with_submitit.py:83-124).

Writes an sbatch script that runs ONE TASK PER GPU: ``--nodes`` hosts with
``--gpus-per-node`` GPUs each, every task starting
``kinet_tpu_torch.tools.launch`` with its coordinates (the first node of
the allocation is the rendezvous, ``SLURM_NODEID`` the host, and
``SLURM_LOCALID`` the task's GPU on it). Preemption: ``--signal=USR1@N``
and ``#SBATCH --requeue`` with the launcher's ``--requeue-on-preempt``,
whose handler checkpoints mid-epoch and requeues (``utils/preempt.py``);
the launcher resumes from ``output_dir/checkpoint.pth``. ``--dry-run``
prints the script; otherwise it is written to ``job_dir/submit.sbatch``
and given to ``sbatch`` where there is one.

    python -m kinet_tpu_torch.tools.slurm_launch --partition gpu \\
        --nodes 2 --gpus-per-node 8 --time 720 --mem 256 \\
        --config train.yaml --named train_deformable train_tracking \\
        [--dry-run] [override key=value ...]
"""
from __future__ import annotations

import argparse
import os
import shlex
import shutil
import subprocess
import sys

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --partition={partition}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={gpus}
#SBATCH --gpus-per-node={gpus}
#SBATCH --cpus-per-task={cpus}
#SBATCH --mem={mem}G
#SBATCH --time={time_min}
#SBATCH --output={job_dir}/%j_%t_log.out
#SBATCH --error={job_dir}/%j_%t_log.err
#SBATCH --signal=USR1@{signal_delay}
#SBATCH --requeue
{extra_directives}
# one task per GPU; the first node of the allocation is the rendezvous
COORD_HOST=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
export KINET_COORDINATOR="$COORD_HOST:{coordinator_port}"
srun --kill-on-bad-exit=1 bash -c '
  exec {python} -m kinet_tpu_torch.tools.launch \\
    --coordinator "$KINET_COORDINATOR" \\
    --num-hosts {nodes} \\
    --host-id "$SLURM_NODEID" \\
    --gpus-per-host {gpus} \\
    --local-rank "$SLURM_LOCALID" \\
    --requeue-on-preempt \\
    {launch_args}
'
"""

_SUBMIT_KEYS = {
    "partition", "nodes", "gpus_per_node", "time", "mem", "cpus_per_task",
    "job_name", "job_dir", "constraint", "comment", "exclude", "account",
    "coordinator_port", "signal_delay",
}


def build_script(args, launch_args: list[str]) -> str:
    extra = []
    if args.constraint:
        extra.append(f"#SBATCH --constraint={args.constraint}")
    if args.comment:
        extra.append(f"#SBATCH --comment={shlex.quote(args.comment)}")
    if args.exclude:
        extra.append(f"#SBATCH --exclude={args.exclude}")
    if args.account:
        extra.append(f"#SBATCH --account={args.account}")
    return SBATCH_TEMPLATE.format(
        job_name=args.job_name, partition=args.partition, nodes=args.nodes,
        gpus=args.gpus_per_node, cpus=args.cpus_per_task, mem=args.mem,
        time_min=args.time, job_dir=args.job_dir,
        signal_delay=args.signal_delay, extra_directives="\n".join(extra),
        coordinator_port=args.coordinator_port, python=args.python,
        launch_args=" ".join(shlex.quote(a) for a in launch_args),
    )


def _submit_config_defaults(path: str) -> dict:
    """Scheduler defaults from a submit config (reference cfgs/submit.yaml
    read by run_with_submitit.py:88-96): keys are the flags' names; an
    unknown key is refused, so that a typo does not pass unnoticed."""
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    unknown = set(raw) - _SUBMIT_KEYS
    if unknown:
        raise SystemExit(f"unknown submit-config keys in {path}: "
                         f"{sorted(unknown)}")
    return raw


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="kinet_tpu_torch on SLURM")
    p.add_argument("--submit-config", default="",
                   help="YAML with scheduler defaults; flags override it")
    p.add_argument("--partition", default="gpu")
    p.add_argument("--nodes", type=int, default=1)
    p.add_argument("--gpus-per-node", type=int, default=8)
    p.add_argument("--time", type=int, default=60 * 72,
                   help="minutes (the reference caps at 60*72)")
    p.add_argument("--mem", type=int, default=256, help="GB per node")
    p.add_argument("--cpus-per-task", type=int, default=8)
    p.add_argument("--job-name", default="kinet")
    p.add_argument("--job-dir", default="runs/slurm")
    p.add_argument("--constraint", default="")
    p.add_argument("--comment", default="")
    p.add_argument("--exclude", default="")
    p.add_argument("--account", default="")
    p.add_argument("--coordinator-port", type=int, default=29500)
    p.add_argument("--signal-delay", type=int, default=60,
                   help="seconds of USR1 warning before preemption")
    p.add_argument("--python", default=sys.executable)
    p.add_argument("--dry-run", action="store_true",
                   help="print the sbatch script instead of submitting")
    # forwarded to kinet_tpu_torch.tools.launch
    p.add_argument("--config", default="train.yaml")
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("overrides", nargs="*", default=[])
    pre, _ = p.parse_known_args(argv)
    if pre.submit_config:
        p.set_defaults(**_submit_config_defaults(pre.submit_config))
    args = p.parse_args(argv)

    launch_args = ["--config", args.config]
    if args.named:
        launch_args += ["--named", *args.named]
    if args.overrides:
        launch_args += ["--", *args.overrides]
    script = build_script(args, launch_args)
    if args.dry_run:
        print(script)
        return 0

    os.makedirs(args.job_dir, exist_ok=True)
    path = os.path.join(args.job_dir, "submit.sbatch")
    with open(path, "w") as fh:
        fh.write(script)
    if shutil.which("sbatch") is None:
        print(f"sbatch not found: the script is in {path}; submit it on a "
              f"SLURM head node", file=sys.stderr)
        return 0
    proc = subprocess.run(["sbatch", path], capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    return proc.returncode


if __name__ == "__main__":
    raise SystemExit(main())
