"""Flash attention forward: the CUDA kernel and its wrappers.

Counterpart of ``split_learning_tpu/ops/flash_attention.py``
(``flash_attention`` and ``flash_attention_with_lse``, whose Pallas
forward kernel is ``_fwd_kernel``). The kernel lives in
``csrc/flash_attention.cu``, whose header gives the design.

Both public functions keep the JAX layout and signatures: q, k, v are
``[B, T, H, D]`` (float32 or bfloat16, 1 <= D <= 256); ``o`` comes back
``[B, T, H, D]`` in the input dtype and ``lse`` ``[B, T, H]`` in
float32. ``causal`` masks col > row; ``strict`` (with ``causal`` only)
masks the diagonal too, so row 0 has no key: ``o = 0``,
``lse = NEG_BIG``.

On a CUDA tensor they launch the kernel or raise; on a CPU tensor they
run :func:`flash_attention_with_lse_plain`, a dense masked softmax in
float32 that is also the card's yardstick of correctness. The kernel
has no backward yet (K6): a CUDA input that requires grad while grad
mode is on raises ``NotImplementedError``. The plain version is
differentiable by autograd as it is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, NEG_BIG, check_launch, current_stream_handle, load_kernels)

NAME = "flash_attention_fwd"
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
_p = ctypes.c_void_p
_i = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernels()["flash_attention"]
    lib.slt_flash_fwd.argtypes = [_p, _p, _p, _p, _p, _i, _i, _i, _i,
                                  ctypes.c_float, _p, _i, _i, _i, _p]
    lib.slt_flash_fwd.restype = _i
    return lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, strict: bool) -> None:
    if strict and not causal:
        raise ValueError("strict=True refines the causal mask and "
                         "requires causal=True")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one shape [B, T, H, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, d = q.shape
    if min(b, t, h, d) < 1:
        raise ValueError(f"flash attention needs B, T, H, D >= 1; got "
                         f"{tuple(q.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")


# --------------------------------------------------------------------- #
# plain version (the kernel's math in PyTorch; CPU path and yardstick)

def flash_attention_with_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, causal: bool = False,
                                   strict: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked softmax attention in float32: ``(o, lse)``."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones(t, t, dtype=torch.bool, device=q.device)
    if causal:
        ok = rows > cols if strict else rows >= cols
    s = s.masked_fill(~ok, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    l_safe = torch.where(live, l, 1.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(
        0, 2, 1, 3)
    lse = torch.where(live, m + torch.log(l_safe), NEG_BIG)
    return o.to(q.dtype), lse[..., 0].permute(0, 2, 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """``o`` of :func:`flash_attention_with_lse_plain`."""
    return flash_attention_with_lse_plain(q, k, v, causal)[0]


# --------------------------------------------------------------------- #
# kernel launch

def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, strict: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: ``(o, lse)``."""
    _check_inputs(q, k, v, causal, strict)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device} "
                             f"(got {x.device})")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"q, k, v must share one dtype of {_DTYPES}; "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward kernel on the card yet (K6, "
            "ROADMAP §2: it comes with transformer training); run the "
            "forward under torch.no_grad()")
    # the kernel walks D with unit stride and everything else by stride
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, t, h), device=q.device, dtype=torch.float32)
    strides = (ctypes.c_int64 * 9)(*(s for x in (q, k, v)
                                     for s in x.stride()[:3]))
    rc = _lib().slt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, t, h, d, d ** -0.5,
        ctypes.cast(strides, ctypes.c_void_p), int(causal), int(strict),
        int(q.dtype == torch.bfloat16), current_stream_handle(q.device))
    check_launch(rc, NAME)
    LAUNCHES.add(NAME)
    return o, lse


# --------------------------------------------------------------------- #
# public entry points (the JAX package's signatures)

def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")
    return False


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             strict: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, T, H, D] -> ([B, T, H, D], [B, T, H] float32)``.

    ``strict`` masks the diagonal too (row > col) and requires
    ``causal``; a fully masked row comes back as ``o = 0``,
    ``lse = NEG_BIG``."""
    if _on_cuda(q):
        return flash_fwd_cuda(q, k, v, causal, strict)
    _check_inputs(q, k, v, causal, strict)
    return flash_attention_with_lse_plain(q, k, v, causal, strict)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise attention, ``[B, T, H, D] -> [B, T, H, D]``: a drop-in
    for :func:`split_learning_tpu_torch.ops.ring_attention.full_attention`
    with the hand-written kernel on the card."""
    return flash_attention_with_lse(q, k, v, causal)[0]
