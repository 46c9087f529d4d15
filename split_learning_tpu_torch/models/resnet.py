"""ResNet-18 for CIFAR-10 (counterpart of
``split_learning_tpu/models/resnet.py``).

The same stages, parameter trees and arithmetic as the flax modules: a
CIFAR stem (3x3 conv, no max-pool), four layers of two basic blocks
(64, 128, 256, 512 channels; the first block of layers 2-4 at stride
2), GroupNorm with 32 groups in place of BatchNorm, global average
pooling and a dense classifier; 11,173,962 parameters. Stage cuts:

- 2 stages (split, federated): stem + layer1 | layer2 .. head;
- 3 stages (u_split): stem + layer1 | layer2 + layer3 | layer4 + head;
- 4 stages (``resnet18_4stage``): stem + layer1 | layer2 | layer3 |
  layer4 + head.

Public tensors stay **NHWC** as in JAX: the input is ``[B, 32, 32, 3]``
and the 2-stage cut ``[B, 32, 32, 64]``. Inside a stage the NHWC tensor
is viewed as NCHW with ``permute`` (a ``channels_last`` tensor, no
copy), as in :mod:`models.cnn`. Parameter names follow the flax module
paths (``conv_stem``, ``gn_stem``, ``block1a.conv1``,
``mid.layer2.block_a.proj``, ``head.fc``); :mod:`interop` maps one onto
the other.

Where flax and PyTorch differ, the port follows flax:

- ``padding="SAME"`` at stride 2 pads a 3x3 conv on an even size by
  ``(0, 1)`` (``lax.padtype_to_pads``), not PyTorch's ``(1, 1)``, which
  gives the same shape over windows shifted by one pixel; the convs pad
  explicitly, as ``lax`` computes it;
- GroupNorm's epsilon is 1e-6 (PyTorch's default is 1e-5), and its
  statistics, scale and bias are float32 whatever the plan dtype, the
  output cast to it at the end;
- the convs have no bias (``use_bias=False``); the classifier has one;
- a bfloat16 plan is flax's mixed precision: float32 parameters, the
  input and kernels cast to bfloat16 at use, the average pool summed in
  float32 (``jnp.mean`` of bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_tpu_torch.core.stage import SplitPlan, Stage
from split_learning_tpu_torch.models.cnn import Dense, _nchw, _nhwc
from split_learning_tpu_torch.utils.flops import conv_pad

_META = "meta"  # stage modules describe shapes only; params live outside
NUM_CLASSES = 10
GN_GROUPS, GN_EPS = 32, 1e-6   # flax nn.GroupNorm's defaults


def _same_pads(size: int, k: int, s: int):
    """``lax.padtype_to_pads`` for SAME on one axis: ``(low, high)``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv(features, (k, k), strides=s, padding="SAME",
    use_bias=False, dtype=...)``: a float32 kernel; input and kernel cast
    to ``dtype`` at use; SAME padding as ``lax`` computes it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype) -> None:
        super().__init__(cin, cout, k, stride=stride, bias=False,
                         device=_META)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (hl, hh), (wl, wh) = (_same_pads(n, k, s) for n in x.shape[2:])
        dt = self.compute_dtype
        x = x.to(dt)
        if hl == hh and wl == wh:
            return F.conv2d(x, self.weight.to(dt), stride=s,
                            padding=(hl, wl))
        # JAX pads inside the convolution: conv_pad says so to the
        # FLOP count
        return F.conv2d(conv_pad(x, (wl, wh, hl, hh)), self.weight.to(dt),
                        stride=s)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(num_groups=32, dtype=...)``: epsilon 1e-6,
    the statistics, scale and bias in float32, the output in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype) -> None:
        super().__init__(GN_GROUPS, channels, eps=GN_EPS, device=_META)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps
                            ).to(self.compute_dtype)


class BasicBlock(nn.Module):
    """conv3x3(stride) -> GN -> ReLU -> conv3x3 -> GN, plus the shortcut
    (a 1x1 conv at the stride and GN where the shape changes), ReLU.
    NCHW views in and out."""

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, dtype)
        self.gn1 = GroupNorm(features, dtype)
        self.conv2 = Conv(features, features, 3, 1, dtype)
        self.gn2 = GroupNorm(features, dtype)
        if stride != 1 or cin != features:
            self.proj = Conv(cin, features, 1, stride, dtype)
            self.gn_proj = GroupNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        if hasattr(self, "proj"):
            x = self.gn_proj(self.proj(x))
        return F.relu(y + x)


class _Stage(nn.Module):
    """A stage whose ``body`` runs on NCHW views: ``forward`` takes and
    gives NHWC, and a composite stage calls its parts' ``body``."""

    def body(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.body(_nchw(x))
        return _nhwc(y) if y.dim() == 4 else y


class Stem(_Stage):
    """CIFAR stem + layer1 (2 blocks of 64):
    ``[B, 32, 32, 3] -> [B, 32, 32, 64]``."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv_stem = Conv(3, 64, 3, 1, dtype)
        self.gn_stem = GroupNorm(64, dtype)
        self.block1a = BasicBlock(64, 64, 1, dtype)
        self.block1b = BasicBlock(64, 64, 1, dtype)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.gn_stem(self.conv_stem(x)))
        return self.block1b(self.block1a(x))


class Layer(_Stage):
    """One ResNet layer: 2 blocks, the first at stride 2."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.block_a = BasicBlock(cin, features, 2, dtype)
        self.block_b = BasicBlock(features, features, 1, dtype)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_b(self.block_a(x))


class Head(_Stage):
    """layer4 + global average pool + classifier:
    ``[B, 8, 8, 256] -> [B, 10]``."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 num_classes: int = NUM_CLASSES) -> None:
        super().__init__()
        self.layer4 = Layer(256, 512, dtype)
        self.fc = Dense(512, num_classes, dtype)
        self.compute_dtype = dtype

    def body(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer4.body(x)
        return self.fc(x.float().mean(dim=(2, 3)).to(self.compute_dtype))


class MidLayers(_Stage):
    """layer2 + layer3 (the U-shaped server's stage)."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.layer2 = Layer(64, 128, dtype)
        self.layer3 = Layer(128, 256, dtype)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer3.body(self.layer2.body(x))


class MidToEnd(_Stage):
    """layer2 .. layer4 + head (the server of the 2-stage cut):
    ``[B, 32, 32, 64] -> [B, 10]``."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.mid = MidLayers(dtype)
        self.head = Head(dtype)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self.head.body(self.mid.body(x))


def resnet18_plan(mode: str = "split", dtype: torch.dtype = torch.float32,
                  stages: int = 0) -> SplitPlan:
    """The ResNet-18 SplitPlan. ``stages=0`` picks the mode's natural
    depth: 2 for split and federated, 3 for u_split; ``stages=4`` (split
    only) is the pipeline cut. Other combinations raise ``ValueError``,
    as JAX's builder does."""
    if stages == 0:
        stages = {"split": 2, "federated": 2, "u_split": 3}[mode]
    if mode == "u_split":
        if stages != 3:
            raise ValueError("u_split resnet18 uses exactly 3 stages")
        return SplitPlan(
            stages=(Stage("stem_l1", Stem(dtype)),
                    Stage("mid", MidLayers(dtype)),
                    Stage("head", Head(dtype))),
            owners=("client", "server", "client"))
    if stages == 2:
        return SplitPlan(
            stages=(Stage("stem_l1", Stem(dtype)),
                    Stage("mid_head", MidToEnd(dtype))),
            owners=("client", "server"))
    if stages == 4:
        return SplitPlan(
            stages=(Stage("stem_l1", Stem(dtype)),
                    Stage("layer2", Layer(64, 128, dtype)),
                    Stage("layer3", Layer(128, 256, dtype)),
                    Stage("head", Head(dtype))),
            owners=("client", "server", "server", "server"))
    raise ValueError(f"unsupported stage count {stages} for mode {mode!r}")
