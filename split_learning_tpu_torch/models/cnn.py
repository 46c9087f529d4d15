"""The split MNIST CNN (counterpart of ``split_learning_tpu/models/cnn.py``).

Same arithmetic and parameter counts as the JAX modules (PartA 320,
PartB 110,666, full 110,986). Public tensors stay **NHWC** as in JAX:
the input is ``[B, 28, 28, 1]`` and the cut tensor ``[B, 26, 26, 32]``.
Inside a stage the NHWC tensor is viewed as NCHW with ``permute``, which
gives PyTorch a ``channels_last`` tensor without a copy, and the output
is viewed back. Stage B flattens in NHWC order, so its ``fc.weight`` is
the flax kernel transposed with no row remap.

Parameter names follow the flax module names (``conv1``, ``conv2``,
``fc``); :mod:`split_learning_tpu_torch.interop` maps one onto the other.

A bfloat16 plan follows flax's ``nn.Conv/nn.Dense(dtype=bfloat16)``:
the parameters stay float32, and the input, kernel and bias are cast to
bfloat16 at use, so the cut tensor and the logits are bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_tpu_torch.core.stage import SplitPlan, Stage

_META = "meta"  # stage modules describe shapes only; params live outside
NUM_CLASSES = 10


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """flax ``nn.Conv(dtype=...)``, 3x3 VALID: float32 parameters; input,
    kernel and bias cast to ``dtype`` at use."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 device=_META) -> None:
        super().__init__(cin, cout, 3, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 parameters; input, kernel and
    bias cast to ``dtype`` at use."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype,
                 device=_META) -> None:
        super().__init__(fan_in, fan_out, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _conv_relu_pool_flatten(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv -> ReLU -> 2x2 max-pool -> flatten in NHWC order."""
    x = F.max_pool2d(F.relu(conv(_nchw(x))), 2)
    return _nhwc(x).reshape(x.shape[0], -1)


class CNNPartA(nn.Module):
    """Client bottom stage: Conv(1->32, 3x3, VALID) + ReLU.

    [B, 28, 28, 1] -> [B, 26, 26, 32]; 320 params."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device=_META) -> None:
        super().__init__()
        self.conv1 = Conv(1, 32, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.relu(self.conv1(_nchw(x))))


class CNNPartB(nn.Module):
    """Server top stage: Conv(32->64) + ReLU -> MaxPool(2) -> Flatten ->
    Dense(10). [B, 26, 26, 32] -> [B, 10]; 110,666 params."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device=_META) -> None:
        super().__init__()
        self.conv2 = Conv(32, 64, dtype, device=device)
        self.fc = Dense(12 * 12 * 64, NUM_CLASSES, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(_conv_relu_pool_flatten(self.conv2, x))


class CNNTrunkB(nn.Module):
    """Server middle stage of the U-shape: PartB minus the head.
    [B, 26, 26, 32] -> [B, 9216]; 18,496 params."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device=_META) -> None:
        super().__init__()
        self.conv2 = Conv(32, 64, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_relu_pool_flatten(self.conv2, x)


class CNNHeadC(nn.Module):
    """Client head stage of the U-shape: Dense(9216->10); 92,170 params."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device=_META) -> None:
        super().__init__()
        self.fc = Dense(12 * 12 * 64, NUM_CLASSES, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


def split_cnn_plan(dtype: torch.dtype = torch.float32) -> SplitPlan:
    """The classic 2-party split: client(A) -> server(B)."""
    return SplitPlan(
        stages=(Stage("part_a", CNNPartA(dtype)),
                Stage("part_b", CNNPartB(dtype))),
        owners=("client", "server"),
    )


def u_split_cnn_plan(dtype: torch.dtype = torch.float32) -> SplitPlan:
    """U-shaped 3-stage split: client(A) -> server(trunk) -> client(head)."""
    return SplitPlan(
        stages=(Stage("part_a", CNNPartA(dtype)),
                Stage("trunk_b", CNNTrunkB(dtype)),
                Stage("head_c", CNNHeadC(dtype))),
        owners=("client", "server", "client"),
    )


def chain3_cnn_plan(dtype: torch.dtype = torch.float32) -> SplitPlan:
    """3-stage chain: client(A) -> server(trunk) -> server(head)."""
    return SplitPlan(
        stages=(Stage("part_a", CNNPartA(dtype)),
                Stage("trunk_b", CNNTrunkB(dtype)),
                Stage("head_c", CNNHeadC(dtype))),
        owners=("client", "server", "server"),
    )
