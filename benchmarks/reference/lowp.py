"""The reference in a lower precision: the control that a comparison has
to fail.

``to_fp8(model)`` makes every convolution and linear of ``model`` compute
as an fp8 (e4m3) product would: its weight, and each input it gets, are
rounded to float8_e4m3fn after scaling the tensor's largest magnitude to
448 (one scale a tensor, as fp8 matrix products take), and multiplied in
float32. The rest stays float32.
"""
from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def to_fp8(model: nn.Module) -> nn.Module:
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            with torch.no_grad():
                mod.weight.copy_(fp8_round(mod.weight))
            mod.register_forward_pre_hook(
                lambda _m, args: (fp8_round(args[0]),) + tuple(args[1:]))
    return model
