"""ResNet backbone with FrozenBatchNorm (port of
``kinet_tpu/models/backbone.py``).

Module names follow the JAX parameter tree (``trunk.layer2_0.conv1`` ...),
so ``tools/from_jax.py`` maps weights one to one. Convolutions run NCHW;
``Backbone`` takes the JAX layout [B, H, W, 3] and returns NCHW features.

The JAX ``StemConv`` is a TPU space-to-depth rewrite of a plain 7x7/s2
convolution with the same [7, 7, 3, 64] parameter; here it is that plain
``nn.Conv2d``.

Training: the stem convolution and ``layer1_*`` are frozen, as are all
FrozenBatchNorm tensors; the rest of the trunk trains at ``lr_backbone``
(the labels are ``engine/state.py::param_labels``).

``LayerBackboneFC`` / ``KinetBackbone`` are the KineT family's MLP
"backbones" over detection and metadata vectors.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .deformable_transformer import Dropout, DropoutRNG


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine.

    The four tensors are parameters, as in the JAX package (``self.param``
    there): they get gradients, which enter the global norm of gradient
    clipping, but the optimizer never updates them (group "frozen",
    ``engine/state.py``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x):  # x [B, C, H, W]
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _call(module, x, stride):
    """``module`` on ``x`` (whose rows are at ``stride`` of the image)."""
    return module(x)


class Bottleneck(nn.Module):
    """torchvision-style ResNet v1.5 bottleneck (stride on the 3x3)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = features * 4
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(
            features, features, 3, stride=stride, padding=dilation,
            dilation=dilation, bias=False,
        )
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        if downsample:
            self.downsample_conv = nn.Conv2d(
                in_ch, out_ch, 1, stride=stride, bias=False
            )
            self.downsample_bn = FrozenBatchNorm(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x, stride: int = 1, conv=_call):
        """``x`` at ``stride`` of the image; ``conv(module, x, stride)`` runs
        each convolution on an input at that stride (``_call``: the
        module itself; ``parallel/sp.py`` passes its halo convolution)."""
        y = torch.relu(self.bn1(conv(self.conv1, x, stride)))
        y = torch.relu(self.bn2(conv(self.conv2, y, stride)))
        y = self.bn3(conv(self.conv3, y, stride * self.conv2.stride[0]))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(
                conv(self.downsample_conv, x, stride))
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """ResNet trunk returning the [C2, C3, C4, C5] pyramid (NCHW)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dilation: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.blocks = []  # [(stage, module name)] in order
        self.strides = []  # each stage's output stride
        in_ch = 64
        widths = (64, 128, 256, 512)
        for stage, (blocks, width) in enumerate(zip(stage_sizes, widths)):
            last = stage == len(stage_sizes) - 1
            dil = 2 if (dilation and last) else 1
            stride = 1 if stage == 0 or (dilation and last) else 2
            self.strides.append((self.strides[-1] if stage else 4) * stride)
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                # DC5 (torchvision replace_stride_with_dilation): the FIRST
                # block of the dilated stage keeps dilation 1; only the
                # remaining blocks run dilation 2
                self.add_module(name, Bottleneck(
                    in_ch, width, stride=stride if b == 0 else 1,
                    dilation=1 if b == 0 else dil, downsample=(b == 0),
                ))
                self.blocks.append((stage, name))
                in_ch = width * 4

    def forward(self, x, conv=_call, pool=_call):  # x [B, 3, H, W]
        """``conv`` / ``pool`` (module, x, stride of x) run the
        convolutions and the max pool (``Bottleneck.forward``)."""
        x = pool(self.maxpool, torch.relu(self.bn1(conv(self.conv1, x, 1))), 2)
        feats, stride = [], 4
        for i, (stage, name) in enumerate(self.blocks):
            block = getattr(self, name)
            x = block(x, stride, conv)
            stride *= block.conv2.stride[0]
            if i + 1 == len(self.blocks) or self.blocks[i + 1][0] != stage:
                feats.append(x)
        return feats


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of each of ``n_out`` samples from ``n_in`` by nearest
    sampling at half-pixel centres, floor((i + 0.5) * n_in / n_out) in
    float32: the rule of ``jax.image.resize(method="nearest")``."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
    return torch.floor(pos * n_in / n_out).long()


def downsample_pad_mask(pad_mask: torch.Tensor, hw) -> torch.Tensor:
    """Resize a [B, H, W] bool pad mask to feature resolution by
    ``nearest_index``."""
    _, h_in, w_in = pad_mask.shape
    rows = nearest_index(h_in, hw[0], pad_mask.device)
    cols = nearest_index(w_in, hw[1], pad_mask.device)
    return pad_mask[:, rows][:, :, cols]


_STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    # 1-block-per-stage trunk for fast tests (as in the JAX package)
    "resnet_test": (1, 1, 1, 1),
}


class Backbone(nn.Module):
    """ResNet + per-level pad masks. With ``return_interm_layers`` it
    exposes C3..C5 (strides 8, 16, 32), else C5 only."""

    def __init__(self, name_arch: str = "resnet50",
                 return_interm_layers: bool = True, dilation: bool = False):
        super().__init__()
        self.return_interm_layers = return_interm_layers
        self.trunk = ResNet(_STAGE_SIZES[name_arch], dilation=dilation)

    def select(self, levels: list) -> list:
        """The levels this backbone returns of the trunk's [C2..C5]."""
        return levels[1:] if self.return_interm_layers else levels[-1:]

    @property
    def strides(self) -> list:
        return self.select(self.trunk.strides)

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor,
                spatial=None):
        """images [B, H, W, 3] -> (features [B, C, h, w] list, masks). With
        ``spatial`` (``parallel/sp.py``) the trunk runs on this process's
        rows and the features are all-gathered whole."""
        if spatial is None:
            feats = self.select(self.trunk(images.permute(0, 3, 1, 2)))
        else:
            feats = [spatial.gather(f, s) for f, s in
                     zip(spatial.features(self, images), self.strides)]
        masks = [
            downsample_pad_mask(pad_mask, f.shape[-2:]) for f in feats
        ]
        return feats, masks

    @property
    def num_channels(self):
        return [512, 1024, 2048] if self.return_interm_layers else [2048]


class BackboneWithMasksAll(Backbone):
    """All four levels C2..C5 (strides 4 to 32), for the mask head's FPN;
    ``num_channels`` stays that of C3..C5."""

    def select(self, levels: list) -> list:
        return list(levels)


class LayerBackboneFC(nn.Module):
    """3-linear MLP + LayerNorm over detection vectors, with the single
    activation after ``linear2``:
    ``norm(linear3(dropout(relu(linear2(dropout(linear1(x)))))))``."""

    # the flax layers are named explicitly, not Dense_{i}
    flax_names = {"linear1": "linear1", "linear2": "linear2",
                  "linear3": "linear3"}

    def __init__(self, in_dim: int, hidden_dim: int, dropout: float = 0.1,
                 rng: DropoutRNG = None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.linear1 = nn.Linear(in_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, hidden_dim)
        self.linear3 = nn.Linear(hidden_dim, hidden_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.dropout1 = Dropout(dropout, rng)
        self.dropout2 = Dropout(dropout, rng)

    def forward(self, x):
        x = self.dropout1(self.linear1(x))
        x = self.dropout2(torch.relu(self.linear2(x)))
        return self.norm(self.linear3(x))


class KinetBackbone(nn.Module):
    """Two ``LayerBackboneFC``: detections [.., det_dim] and metadata
    [.., meta_dim] both to ``hidden_dim``."""

    def __init__(self, det_dim: int, meta_dim: int, hidden_dim: int,
                 dropout: float = 0.1, rng: DropoutRNG = None):
        super().__init__()
        self.det_backbone = LayerBackboneFC(det_dim, hidden_dim, dropout, rng)
        self.meta_backbone = LayerBackboneFC(meta_dim, hidden_dim, dropout,
                                             rng)

    def forward(self, detections, metadata):
        return self.det_backbone(detections), self.meta_backbone(metadata)
