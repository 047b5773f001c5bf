"""Residual CNN classifier in PyTorch, numerically after the flax zoo.

Counterpart of ``gpuschedule_tpu/models/cnn.py`` (``ResBlock``,
``ResNet``): the vision family of the zoo (:class:`~.config.CnnConfig`).
Images are NHWC ``(B, H, W, 3)`` f32, as the JAX trainer feeds them, and
stay NHWC between layers; f32 parameters, bf16 compute, logits cast to f32.

Parameters keep flax's names and shapes: a conv kernel is
``(kh, kw, cin, cout)`` with a bias (flax ``Conv`` has ``use_bias=True``),
permuted to OIHW at the call; the input is permuted to NCHW as a view, so
the convolution sees a ``channels_last`` tensor and hands one back.

Flax numerics reproduced (read from the installed flax 0.12.3):

- ``Conv(dtype=bf16)``: input, kernel and bias cast to bf16, the product
  rounded to bf16 before the bias is added; ``padding="SAME"`` keeps
  ceil(size / stride) outputs and puts an odd pixel of padding on the high
  side (lax's ``padtype_to_pads``): a 3×3 stride-2 conv on an even size
  pads low 0, high 1, where PyTorch's ``padding=1`` would pad 1 on both
  sides and shift every output by a pixel;
- ``GroupNorm(num_groups=8, dtype=bf16)``: eps 1e-6, mean and
  ``E[x²] - E[x]²`` variance in f32 over (H, W, the group's channels), f32
  scale and bias, output bf16;
- ``jnp.mean`` of bf16: an f32 sum, the mean rounded to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gpuschedule_tpu_torch.models.config import CnnConfig
from gpuschedule_tpu_torch.models.transformer import BF16, Dense, lecun_normal_


def same_pads(size: int, k: int, stride: int):
    """(low, high) padding of flax's ``"SAME"`` along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``Conv(features, (k, k), strides, padding="SAME", dtype=bf16)``
    on NHWC tensors."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        k, _, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, k * k * cin, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hl, hh), (wl, wh) = (same_pads(n, self.k, self.stride) for n in x.shape[1:3])
        x = x.to(BF16)
        if (hl, wl) != (hh, wh):  # uneven: pad first (still NHWC), then no padding
            x = F.pad(x, (0, 0, wl, wh, hl, hh))
            hl = wl = 0
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(BF16).permute(3, 2, 0, 1),
                     stride=self.stride, padding=(hl, wl))
        return y.permute(0, 2, 3, 1) + self.bias.to(BF16)


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups, dtype=bf16)`` over NHWC: f32 statistics
    per (sample, group), bf16 output."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6):
        super().__init__()
        if channels % groups:
            raise ValueError(f"Number of groups ({groups}) does not divide the number "
                             f"of channels ({channels}).")
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        grouped = (self.groups, c // self.groups)
        g = x.float().reshape(b, h, w, *grouped)
        mean = g.mean(dim=(1, 2, 4), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(1, 2, 4), keepdim=True) - mean * mean, min=0.0)
        y = (g - mean) * (torch.rsqrt(var + self.eps) * self.scale.view(grouped))
        return (y + self.bias.view(grouped)).reshape(b, h, w, c).to(BF16)


class ResBlock(nn.Module):
    """3x3-3x3 residual block, pre-norm, bf16 compute; a 1x1 ``proj`` on
    the shortcut when the width or the stride changes."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.gn1 = GroupNorm(cin)
        self.conv1 = Conv(cin, ch, 3, stride)
        self.gn2 = GroupNorm(ch)
        self.conv2 = Conv(ch, ch, 3)
        self.proj = Conv(cin, ch, 1, stride) if (cin != ch or stride != 1) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.gn1(x)))
        h = self.conv2(F.relu(self.gn2(h)))
        if self.proj is not None:
            x = self.proj(x)
        return x + h


class ResNet(nn.Module):
    """Stem → stages (downsample 2x, widen) → pooled linear head.  The
    blocks are the attributes ``s{stage}b{block}``, flax's names."""

    def __init__(self, cfg: CnnConfig):
        super().__init__()
        self.cfg = cfg
        self.stem = Conv(3, cfg.channels[0], 3)
        self.block_names = []
        cin = cfg.channels[0]
        for si, ch in enumerate(cfg.channels):
            for bi in range(cfg.blocks_per_stage):
                name = f"s{si}b{bi}"
                self.add_module(name, ResBlock(cin, ch, 2 if (bi == 0 and si > 0) else 1))
                self.block_names.append(name)
                cin = ch
        self.gn_f = GroupNorm(cin)
        self.head = Dense((cin,), (cfg.num_classes,))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's default initialisers (``lecun_normal`` kernels, zero
        biases, unit norm scales), drawn from ``gen`` in module order."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.reset_parameters(gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """f32 logits ``(B, num_classes)`` of NHWC ``images``."""
        x = self.stem(images.to(BF16))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.relu(self.gn_f(x))
        x = x.float().mean(dim=(1, 2)).to(BF16)  # global average pool
        return self.head(x).float()

