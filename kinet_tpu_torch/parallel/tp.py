"""Tensor parallelism over the mesh's ``model`` axis (port of
``kinet_tpu/parallel/tp.py``).

The JAX package annotates its parameters with Megatron-style
PartitionSpecs and lets GSPMD insert the collectives. Here the same
shardings are real modules: ``shard_params_tp`` swaps every sharded
``nn.Linear`` / ``nn.Conv2d`` for a parallel module that holds only its
rank's shard and calls the collectives itself.

Rules (JAX ``tp.py:1-22``, ``_module_specs``), in torch layout, for
``n = mesh.model``:

- ``nn.Linear`` [out, in]: column-parallel (weight dim 0, bias dim 0) when
  ``out % n == 0 and out >= in``; else row-parallel (weight dim 1, bias
  replicated) when ``in % n == 0``;
- the projections of a ``MultiheadAttention`` (flax DenseGeneral,
  ``query/key/value`` [C, H, dh] and ``out`` [H, dh, C]): q/k/v
  column-parallel by heads and ``out_proj`` row-parallel, when the head
  count divides, else replicated;
- ``nn.Conv2d``: the output channels (weight dim 0, bias dim 0) when they
  divide;
- everything else (norms, FrozenBN, embeddings, heads that do not
  divide) is replicated.

Activations between modules stay replicated, so everything else (the MSDA
kernels, the matcher, the criterion) sees whole tensors as at ``n = 1``:

- a column-parallel module computes its output channels and all-gathers
  them over the model group; the all-gather's backward takes the rank's
  own slice, and the input's gradient (a partial sum on each rank) is
  all-reduced;
- a row-parallel module slices its replicated input, all-reduces its
  partial output and then adds the replicated bias; its backward
  all-gathers the input-gradient slices, so the input's gradient is
  replicated on every rank.

Each rank of a model group computes the replicated parameters' gradients
on its own card, so after the data group's mean they are averaged over
the model group too (``engine/train_step.py``): their copies take one
update and cannot drift apart.

The collectives are ``torch.autograd.Function`` s over ``utils/dist.py``
(staged through the CPU under gloo, on the card under NCCL). Parameters
stay plain tensors (no DTensor), so ``functional_call`` on bf16 casts,
the hand-written gradient clip and ``state_dict`` see them as they are.
``full_state_dict`` / ``local_state_dict`` and the optimizer's
(``engine/state.py``) turn shards into whole tensors and back, so a
checkpoint holds whole tensors whatever the mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from ..utils.dist import all_gather_cat, all_reduce_sum, group_size


def _rank(group) -> int:
    return 0 if group is None else tdist.get_rank(group)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes the rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        start = _rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    """The rank's slice along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = group_size(group)
        ctx.dim, ctx.group = dim, group
        size = x.shape[dim] // n
        return x.narrow(dim, _rank(group) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shard(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.detach().narrow(dim, r * size, size).clone()


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=like.requires_grad)


class ColumnParallelLinear(nn.Linear):
    """The rank's rows [out / n, in] of a linear layer and its bias;
    output all-gathered over the model group. ``out_start`` is the first
    output row the rank holds."""

    tp_dims = {"weight": 0, "bias": 0}

    def __init__(self, linear: nn.Linear, group):
        nn.Module.__init__(self)
        n, r = group_size(group), _rank(group)
        self.group = group
        self.in_features = linear.in_features
        self.out_features = linear.out_features // n
        self.out_start = r * self.out_features
        self.weight = _param(_shard(linear.weight, 0, n, r), linear.weight)
        if linear.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = _param(_shard(linear.bias, 0, n, r), linear.bias)

    def copy_input(self, x):
        """``x``, whose gradient is summed over the model group (each rank
        gives the part its rows see)."""
        return _CopyToModel.apply(x, self.group)

    def gather_output(self, y):
        return _GatherFromModel.apply(y, y.dim() - 1, self.group)

    def forward(self, x):
        return self.gather_output(
            F.linear(self.copy_input(x), self.weight, self.bias))


class RowParallelLinear(nn.Linear):
    """The rank's columns [out, in / n] of a linear layer; the input
    sliced, the partial outputs all-reduced, then the replicated bias."""

    tp_dims = {"weight": 1}

    def __init__(self, linear: nn.Linear, group):
        nn.Module.__init__(self)
        n, r = group_size(group), _rank(group)
        self.group = group
        self.in_features = linear.in_features // n
        self.out_features = linear.out_features
        self.weight = _param(_shard(linear.weight, 1, n, r), linear.weight)
        if linear.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = _param(linear.bias.detach().clone(), linear.bias)

    def forward(self, x):
        x = _ScatterToModel.apply(x, x.dim() - 1, self.group)
        y = _ReduceFromModel.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class ColumnParallelConv2d(nn.Conv2d):
    """The rank's output channels of a convolution (and of its bias); the
    output all-gathered over the channels."""

    tp_dims = {"weight": 0, "bias": 0}

    def __init__(self, conv: nn.Conv2d, group):
        nn.Module.__init__(self)
        n, r = group_size(group), _rank(group)
        self.group = group
        for k in ("in_channels", "kernel_size", "stride", "padding",
                  "dilation", "groups", "padding_mode", "transposed",
                  "output_padding", "_reversed_padding_repeated_twice"):
            setattr(self, k, getattr(conv, k))
        self.out_channels = conv.out_channels // n
        self.weight = _param(_shard(conv.weight, 0, n, r), conv.weight)
        if conv.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = _param(_shard(conv.bias, 0, n, r), conv.bias)

    def forward(self, x):
        x = _CopyToModel.apply(x, self.group)
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return _GatherFromModel.apply(y, 1, self.group)


_MHA_PROJ = ("q_proj", "k_proj", "v_proj", "out_proj")


def _module_rule(parent, child_name, module, n):
    """"column", "row", "conv" or None for one module."""
    from ..models.deformable_transformer import MultiheadAttention

    if isinstance(module, nn.Linear):
        if isinstance(parent, MultiheadAttention) and child_name in _MHA_PROJ:
            if parent.n_heads % n:
                return None
            return "row" if child_name == "out_proj" else "column"
        o, i = module.out_features, module.in_features
        if o % n == 0 and o >= i:
            return "column"
        if i % n == 0:
            return "row"
        return None
    if isinstance(module, nn.Conv2d):
        return "conv" if module.out_channels % n == 0 else None
    return None


_DIMS = {"column": {"weight": 0, "bias": 0}, "row": {"weight": 1},
         "conv": {"weight": 0, "bias": 0}}
_CLASSES = {"column": ColumnParallelLinear, "row": RowParallelLinear,
            "conv": ColumnParallelConv2d}


def _sharded_modules(model: nn.Module, n: int):
    """[(parent, child name, module path, rule)] of every module to shard."""
    out = []
    for path, parent in model.named_modules():
        for name, child in parent.named_children():
            rule = _module_rule(parent, name, child, n)
            if rule is not None:
                out.append((parent, name, f"{path}.{name}" if path else name,
                            rule))
    return out


def tp_partition_specs(model: nn.Module, n_model: int) -> dict:
    """{parameter name: the dimension it is sharded on, or None for
    replicated} for every parameter of ``model`` (unsharded) at
    ``n_model`` model shards."""
    specs = {name: None for name, _ in model.named_parameters()}
    if n_model <= 1:
        return specs
    for _, _, path, rule in _sharded_modules(model, n_model):
        for leaf, dim in _DIMS[rule].items():
            if f"{path}.{leaf}" in specs:
                specs[f"{path}.{leaf}"] = dim
    return specs


def shard_params_tp(model: nn.Module, mesh) -> nn.Module:
    """Swaps, in place, every module that ``tp_partition_specs`` shards for
    its parallel module over ``mesh.model_group``, holding the rank's shard;
    returns ``model``, which remembers the mesh (``mesh_of``). Call it
    before building the optimizer, so the AdamW moments are shards too
    (JAX ``tp.py:77-80``)."""
    model.tp_mesh = mesh
    if mesh.model <= 1:
        return model
    swapped = {}  # a module held by two parents becomes one parallel module
    for parent, name, _, rule in _sharded_modules(model, mesh.model):
        old = getattr(parent, name)
        if id(old) not in swapped:
            swapped[id(old)] = _CLASSES[rule](old, mesh.model_group)
        setattr(parent, name, swapped[id(old)])
    return model


def sharded_dims(model: nn.Module) -> dict:
    """{parameter name: its shard dimension} of a model after
    ``shard_params_tp``; empty for a model with no parallel module."""
    out = {}
    for path, module in model.named_modules():
        for leaf, dim in getattr(module, "tp_dims", {}).items():
            if getattr(module, leaf, None) is not None:
                out[f"{path}.{leaf}" if path else leaf] = dim
    return out


def model_group(model: nn.Module):
    mesh = getattr(model, "tp_mesh", None)
    return None if mesh is None else mesh.model_group


@torch.no_grad()
def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every shard all-gathered into its whole
    tensor over the model group (collective: every rank of the group calls
    it); the state dict itself without tensor parallelism."""
    state = model.state_dict()
    dims = sharded_dims(model)
    if not dims:
        return state
    group = model_group(model)
    return {k: all_gather_cat(v, dims[k], group) if k in dims else v
            for k, v in state.items()}


def local_state_dict(model: nn.Module, state: dict) -> dict:
    """``state`` (whole tensors) with each sharded parameter cut to this
    rank's shard."""
    dims = sharded_dims(model)
    if not dims:
        return state
    group = model_group(model)
    n, r = group_size(group), _rank(group)
    return {k: _shard(v, dims[k], n, r) if k in dims else v
            for k, v in state.items()}
