"""Helpers for runs over several processes (port of
``kinet_tpu/utils/dist.py``; reference util/misc.py:91-159, 462-538), on
``torch.distributed``.

A run over several processes initialises the default process group first
(``tools/launch.py``): NCCL when each process drives a card of its own,
gloo on the CPU and for processes that share one card (NCCL refuses two
ranks on one device). Without an initialised group every helper is the
one-process identity, so a process with no group and one whose group has a
single process run the same code.

Collectives take their tensors where the backend wants them
(``comm_device``): on the rank's card under NCCL, on the CPU under gloo.
"""
from __future__ import annotations

import builtins
import pickle

import torch
import torch.distributed as tdist


def is_dist_avail_and_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_world_size() -> int:
    return tdist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank() -> int:
    return tdist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_buf_bytes(lengths) -> int:
    """Per-process payload buffer size: the longest payload (at least 1, so
    the gather always ships a non-empty tensor)."""
    return max(1, max(int(n) for n in lengths))


def all_gather_objects(obj) -> list:
    """Every process's ``obj`` (picklable), in rank order (reference
    all_gather, misc.py:91-132). Two phases, as the reference's: the
    payloads' byte lengths first, then the payloads padded only to the
    longest, so the traffic is proportional to the payloads."""
    world = get_world_size()
    if world == 1:
        return [obj]
    dev = comm_device()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(n) for _ in range(world)]
    tdist.all_gather(lengths, n)
    lengths = [int(x.item()) for x in lengths]
    size = _gather_buf_bytes(lengths)
    buf = torch.zeros(size, dtype=torch.uint8, device=dev)
    buf[: payload.numel()] = payload.to(dev)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    tdist.all_gather(bufs, buf)
    # the bytes come from this run's own processes
    return [pickle.loads(b[:k].cpu().numpy().tobytes())
            for b, k in zip(bufs, lengths)]


def group_size(group) -> int:
    """The number of processes of ``group``; 1 for None (a mesh axis of
    one process, ``parallel/mesh.py``)."""
    return 1 if group is None else tdist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, on ``t``'s device; ``t`` itself for
    a group of one process."""
    if group_size(group) == 1:
        return t
    buf = t.detach().to(comm_device(), copy=True).contiguous()
    tdist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every process's ``t`` (all of one shape) concatenated along ``dim``
    in rank order of ``group``, on ``t``'s device; ``t`` itself for a group
    of one process."""
    n = group_size(group)
    if n == 1:
        return t
    buf = t.detach().to(comm_device()).contiguous()
    parts = [torch.empty_like(buf) for _ in range(n)]
    tdist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(t.device)


def all_gather_uneven(t: torch.Tensor, sizes, dim: int, group) -> list:
    """Every process's ``t``, whose extent along ``dim`` is ``sizes[r]`` on
    rank r of ``group`` (the other dims alike), as a list in rank order on
    ``t``'s device: one all-gather of ``t`` zero-padded to the largest."""
    n = group_size(group)
    if n == 1:
        return [t]
    size = max(sizes)
    buf = t.detach().to(comm_device())
    if buf.shape[dim] < size:
        pad = list(buf.shape)
        pad[dim] = size - buf.shape[dim]
        buf = torch.cat([buf, buf.new_zeros(pad)], dim)
    buf = buf.contiguous()
    parts = [torch.empty_like(buf) for _ in range(n)]
    tdist.all_gather(parts, buf, group=group)
    return [p.narrow(dim, 0, k).to(t.device) for p, k in zip(parts, sizes)]


def mean_over_processes(t: torch.Tensor) -> torch.Tensor:
    """The mean of tensor ``t`` over the group's processes, on ``t``'s
    device; ``t`` itself in a run of one process. Under a tensor-parallel
    mesh (``parallel/mesh.py``) the processes of a model group hold the
    same value, so its copies do not change the mean."""
    world = get_world_size()
    if world == 1:
        return t
    buf = t.detach().to(comm_device(), copy=True)
    tdist.all_reduce(buf)
    return (buf / world).to(t.device)


def reduce_dict(d: dict) -> dict:
    """{key: the mean of the value over the processes} for a dict of
    scalars (floats or one-element tensors) with the same keys on every
    process (reference reduce_dict, misc.py:135-159); ``d`` itself in a
    run of one process. The processes of a model group (tensor parallel)
    hold the same values, so the mean is the data groups' mean."""
    if get_world_size() == 1:
        return d
    keys = sorted(d)
    vals = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64)
    vals = mean_over_processes(vals)
    return dict(zip(keys, vals.tolist()))


def all_reduce_grads(params, bucket_elems: int = 1 << 24,
                     group="all") -> None:
    """Replaces the gradient of every parameter in ``params`` with its mean
    over the processes of ``group`` (default: every process): the
    global-mean gradient of data-parallel training. Under a
    tensor-parallel mesh the group is the mesh's data group only: the
    processes of a model group hold different shards of a sharded
    parameter, which must never be mixed. A parameter without a gradient
    takes a zero one first, as ``Optimizer.step`` would give it, so every
    process reduces the same tensors. The gradients go in flat buckets of
    one dtype and device of at most ``bucket_elems`` elements, in
    parameter order. Nothing happens for a group of one process."""
    if group == "all":
        world, group = get_world_size(), None
    else:
        world = group_size(group)
    if world == 1:
        return
    dev = comm_device()
    bucket, size = [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket]).to(dev)
        tdist.all_reduce(flat, group=group)
        flat = flat.div_(world).to(bucket[0].device)
        off = 0
        for g in bucket:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()

    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad
        if bucket and (size + g.numel() > bucket_elems
                       or g.dtype != bucket[0].dtype
                       or g.device != bucket[0].device):
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        flush()


def save_on_master(save_fn, *args, **kwargs):
    if is_main_process():
        save_fn(*args, **kwargs)


def setup_for_distributed(is_master: bool | None = None):
    """Silences ``print`` on every process but the main one, unless called
    with ``force=True`` (reference util/misc.py:462-483)."""
    if is_master is None:
        is_master = is_main_process()
    if is_master:
        return
    orig_print = builtins.print

    def print_(*args, force: bool = False, **kwargs):
        if force:
            orig_print(*args, **kwargs)

    builtins.print = print_
