"""The split Vision Transformer (counterpart of
``split_learning_tpu/models/vit.py``).

The transformer trunk of :mod:`models.transformer` on images, through a
patchify stem, under the same plan machinery as every family:

- split:   client(patch-embed + N_c blocks) -> server(N_s blocks + head)
- u_split: client(patch-embed + N_c blocks) -> server(N_s blocks)
           -> client(LN + mean-pool + Dense head)
- federated: the composition of the split plan.

The cut tensor is the patch-token stream ``[B, T, d_model]``, ``T =
(H/p)(W/p)``: 49 for MNIST's 28x28 at patch 4, 64 for CIFAR-10's 32x32.
The server stages are the transformer classifier's own ``TrunkStage``,
``HeadStage`` and ``TrunkAndHead``, non-causal. Parameter names follow
the flax module paths (``patch.weight``, ``pos``, ``block0.mha.q.weight``,
``trunk.block1.ln2.weight``, ``head.fc.weight``).

As in flax, the patch conv is a ``patch x patch`` VALID conv at stride
``patch`` with a bias, run on the NCHW view of the NHWC image; its NHWC
output ``[B, H/p, W/p, d]`` is reshaped to ``[B, T, d]`` (row-major over
the patch grid, the order of ``pos``). ``pos`` is a raw ``[max_tokens,
d_model]`` table in the plan dtype. flax infers the conv's input
channels from the sample at init; the port's modules describe their
shapes up front, so ``vit_plan`` takes ``channels`` (1 for MNIST and the
synthetic set, 3 for CIFAR-10; ``launch.run`` derives it from the
dataset). It sizes only the init: a plan applies parameters of any
channel count.

``attn`` is ``"full"`` (dense), ``"flash"`` (the K5/K6 kernels),
``"auto"`` (one of the two per shape, as the transformer's) or a
sequence-parallel form over ``mesh``'s ``seq`` axis (``"ring"``,
``"ring_flash"``, ``"ulysses"``; the patch tokens are the sequence). On
a ``seq`` axis the fused trainer's step partitions the patch tokens:
seq rank s runs the stem on the image rows that hold its T/n tokens
and keeps those (``PatchEmbedStage._forward_blocks``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_tpu_torch.core.stage import SplitPlan, Stage
from split_learning_tpu_torch.models.cnn import _nchw
from split_learning_tpu_torch.models.transformer import (
    HeadStage, TrunkAndHead, TrunkStage, _make_blocks, _thread_blocks,
    check_attn)
from split_learning_tpu_torch.parallel.tensor import (
    SeqBlocks, SeqInput, on_block)

_META = "meta"  # stage modules describe shapes only; params live outside


class PatchConv(nn.Conv2d):
    """flax ``nn.Conv(d_model, (p, p), strides=p, padding="VALID",
    dtype=...)``: float32 kernel and bias, input, kernel and bias cast to
    ``dtype`` at use."""

    def __init__(self, channels: int, d_model: int, patch: int,
                 dtype: torch.dtype) -> None:
        super().__init__(channels, d_model, patch, stride=patch,
                         device=_META)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride)


class PatchEmbedStage(nn.Module):
    """Client bottom stage: ``[B, H, W, C] -> [B, T, d_model]``.

    A non-overlapping ``patch x patch`` conv, learned positional
    embeddings over the ``max_tokens`` grid, then ``depth`` non-causal
    transformer blocks. H and W must divide by ``patch`` and T must not
    exceed ``max_tokens`` (``ValueError`` otherwise, as in JAX)."""

    takes_seq_input = True   # a seq-partitioned step starts here

    def __init__(self, d_model: int, num_heads: int, depth: int,
                 patch: int = 4, max_tokens: int = 256, attn: str = "full",
                 dtype: torch.dtype = torch.float32,
                 channels: int = 1, mesh: Any = None) -> None:
        super().__init__()
        self.depth, self.max_tokens, self.d_model = depth, max_tokens, d_model
        self.patch_size = patch
        self.patch = PatchConv(channels, d_model, patch, dtype)
        self.pos = nn.Parameter(torch.empty(max_tokens, d_model, dtype=dtype,
                                            device=_META))
        _make_blocks(self, depth, d_model=d_model, num_heads=num_heads,
                     attn=attn, causal=False, dtype=dtype, mesh=mesh)

    def _grid(self, x: torch.Tensor) -> tuple:
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} does not tile into {p}x{p} "
                             "patches")
        t = (h // p) * (w // p)
        if t > self.max_tokens:
            raise ValueError(f"{t} patch tokens > max_tokens "
                             f"{self.max_tokens}")
        return b, w // p, t

    def _forward_blocks(self, inp: SeqInput) -> SeqBlocks:
        """Seq rank s takes the image rows that hold its T/n patch tokens
        (whole patch rows; a row its neighbour shares is computed on
        both), runs the stem on them and keeps its tokens and its slice
        of ``pos``."""
        x, p = inp.x, self.patch_size
        b, gw, t = self._grid(x)
        if t % inp.n:
            raise ValueError(f"{t} patch tokens do not divide over the "
                             f"'seq' axis ({inp.n})")
        tl = t // inp.n
        out = []
        for s, dev in enumerate(inp.devs):
            lo, hi = s * tl, (s + 1) * tl
            r0, r1 = lo // gw, -(-hi // gw)
            with on_block(s):
                y = self.patch(_nchw(x[:, r0 * p:r1 * p].to(dev)))
                y = y.permute(0, 2, 3, 1).reshape(b, (r1 - r0) * gw,
                                                  self.d_model)
                out.append(y[:, lo - r0 * gw:hi - r0 * gw]
                           + self.pos[lo:hi][None])
        return _thread_blocks(self, self.depth, SeqBlocks(out, inp.devs), 0,
                              None, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, SeqInput):
            return self._forward_blocks(x)
        b, _, t = self._grid(x)
        y = self.patch(_nchw(x))                          # [B, d, H/p, W/p]
        y = y.permute(0, 2, 3, 1).reshape(b, t, self.d_model)
        y = y + self.pos[None, :t]
        return _thread_blocks(self, self.depth, y, 0, None, None)


def vit_plan(mode: str = "split", dtype: torch.dtype = torch.float32, *,
             d_model: int = 64, num_heads: int = 4, patch: int = 4,
             client_depth: int = 1, server_depth: int = 2,
             num_classes: int = 10, max_tokens: int = 256,
             mesh: Optional[Any] = None, attn: str = "full",
             channels: int = 1) -> SplitPlan:
    """Build the split-ViT :class:`SplitPlan` for ``mode`` (JAX's
    signature, plus ``channels``, the image's channel count the patch
    conv's init is drawn for)."""
    check_attn(attn)
    common = dict(attn=attn, causal=False, dtype=dtype, mesh=mesh)
    embed = Stage("patch_embed", PatchEmbedStage(
        d_model, num_heads, client_depth, patch=patch, max_tokens=max_tokens,
        attn=attn, dtype=dtype, channels=channels, mesh=mesh))
    if mode == "u_split":
        return SplitPlan(
            stages=(embed,
                    Stage("trunk", TrunkStage(d_model, num_heads,
                                              server_depth, **common)),
                    Stage("head", HeadStage(d_model, num_classes, dtype))),
            owners=("client", "server", "client"))
    # split and federated share the 2-stage plan
    return SplitPlan(
        stages=(embed,
                Stage("trunk_head", TrunkAndHead(
                    d_model, num_heads, server_depth, num_classes,
                    lm_vocab=0, **common))),
        owners=("client", "server"))
