"""Preemption handling (port of ``kinet_tpu/utils/preempt.py``; reference
run_with_submitit.py:42-80).

The launcher (``tools/launch.py --requeue-on-preempt``) installs a handler
for SIGTERM and SIGUSR1, which SLURM sends ahead of a preemption
(``tools/slurm_launch.py`` asks for SIGUSR1 with ``--signal``). The
handler only raises a flag; the train loop polls ``requested()`` once a
step, saves a mid-epoch checkpoint and returns, and the launcher re-execs
itself, whose auto-resume picks the checkpoint up.
"""
from __future__ import annotations

import signal

_requested = False


def request(*_args):
    """Marks a preemption as requested (the signal handler; tests)."""
    global _requested
    _requested = True


def requested() -> bool:
    return _requested


def clear():
    global _requested
    _requested = False


def install(signals=(signal.SIGTERM, signal.SIGUSR1)) -> dict:
    """Installs the handler; returns the previous handlers."""
    return {s: signal.signal(s, request) for s in signals}
