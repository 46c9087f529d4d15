"""Flash attention: the CUDA kernels (forward K5, backward K6) and their
wrappers.

Counterpart of ``split_learning_tpu/ops/flash_attention.py``
(``flash_attention`` and ``flash_attention_with_lse``, whose Pallas
kernels are ``_fwd_kernel`` and, behind ``_make_flash``'s custom VJP,
``_onepass_bwd_kernel`` or ``_dq_kernel`` + ``_dkv_kernel``). The
kernels live in ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward), whose headers give the
designs.

Both public functions keep the JAX layout and signatures: q, k, v are
``[B, T, H, D]`` (float32 or bfloat16, 1 <= D <= 256); ``o`` comes back
``[B, T, H, D]`` in the input dtype and ``lse`` ``[B, T, H]`` in
float32. ``causal`` masks col > row; ``strict`` (with ``causal`` only)
masks the diagonal too, so row 0 has no key: ``o = 0``,
``lse = NEG_BIG``.

Both are differentiable in every output through
:class:`FlashAttentionFunction`, which saves q, k, v, o and the LSE, as
JAX's ``vjp_fwd`` does. On CUDA tensors its forward launches K5 and its
backward K6, or they raise; on CPU tensors they run
:func:`flash_attention_with_lse_plain` and
:func:`flash_attention_bwd_plain`, dense versions of the same math that
are also the card's yardstick of correctness. ``meta`` tensors (a
FLOP count's shape pass, :func:`~split_learning_tpu_torch.utils.flops.
step_flops`) take the plain versions too, whose T x T x D products (two
forward, five backward) are the kernels' model FLOPs.

Where the plain versions round. Every product accumulates in float32,
and the softmax, the LSE, delta and dS = P (dP - delta) are float32. The
kernels hand P and dS to their second products in the operand type, as
the JAX kernels do (``p.astype(vb.dtype)``, ``ds.astype(kb.dtype)``), so
the plain versions round there too (:func:`_as_operand`): P before
``P V`` and ``P^T dO``, dS before ``dS K`` and ``dS^T Q``. The row sum l
is taken over the unrounded P. For float32 inputs that rounding is the
identity, and nothing is rounded before the outputs.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Optional, Tuple

import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, NEG_BIG, check_launch, current_stream_handle, load_kernels)

NAME = "flash_attention_fwd"
# the backward's three launches, in order (csrc/flash_attention_bwd.cu)
BWD_DELTA = "flash_attention_bwd_delta"
BWD_DKV = "flash_attention_bwd_dkv"
BWD_DQ = "flash_attention_bwd_dq"
BWD_NAMES = (BWD_DELTA, BWD_DKV, BWD_DQ)
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernels()["flash_attention"]
    lib.slt_flash_fwd.argtypes = [_p, _p, _p, _p, _p, _i, _i, _i, _i,
                                  _f, _p, _i, _i, _i, _p]
    lib.slt_flash_fwd.restype = _i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = load_kernels()["flash_attention_bwd"]
    lib.slt_flash_bwd_delta.argtypes = [_p, _p, _p, _p, _i, _i, _i, _i, _p,
                                        _i, _p]
    lib.slt_flash_bwd_dkv.argtypes = [_p, _p, _p, _p, _p, _p, _p, _p, _i,
                                      _i, _i, _i, _f, _p, _i, _i, _i, _p]
    lib.slt_flash_bwd_dq.argtypes = [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                                     _i, _f, _p, _i, _i, _i, _p]
    for fn in (lib.slt_flash_bwd_delta, lib.slt_flash_bwd_dkv,
               lib.slt_flash_bwd_dq):
        fn.restype = _i
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

def _live(t: int, causal: bool, strict: bool,
          device: torch.device) -> torch.Tensor:
    """``[T, T]`` mask of the (query row, key col) pairs that attend."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    if not causal:
        return torch.ones(t, t, dtype=torch.bool, device=device)
    return rows > cols if strict else rows >= cols


def _as_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` as the second product of a kernel sees it: rounded
    to the operand ``dtype`` (the identity for float32)."""
    return x.to(dtype).float()


def flash_attention_with_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, causal: bool = False,
                                   strict: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked softmax attention, ``(o, lse)``: float32 sums, P in
    the operand dtype for ``P V``."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    ok = _live(t, causal, strict, q.device)
    s = s.masked_fill(~ok, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    l_safe = torch.where(live, l, 1.0)
    o = torch.einsum("bhqk,bkhd->bqhd", _as_operand(p, q.dtype),
                     v.float()) / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(live, m + torch.log(l_safe), NEG_BIG)
    return o.to(q.dtype), lse[..., 0].permute(0, 2, 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """``o`` of :func:`flash_attention_with_lse_plain`."""
    return flash_attention_with_lse_plain(q, k, v, causal)[0]


def flash_bwd_delta_plain(o: torch.Tensor, do: torch.Tensor,
                          g_lse: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``delta = rowsum(dO * O) - g_lse``, ``[B, T, H]`` float32, as the
    delta kernel; ``g_lse`` None is zero."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if g_lse is None else delta - g_lse.float()


def _probs_and_dscores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool, strict: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P (recomputed from the LSE) and dS = P (dP - delta), both
    ``[B, H, T, T]`` float32; masked entries are 0 after the exp."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    ok = _live(t, causal, strict, q.device)
    row = lambda x: x.float().permute(0, 2, 1)[..., None]   # [B, H, T, 1]
    p = torch.where(ok, torch.exp(s - row(lse)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - row(delta))


def _grads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, strict: bool, dq: bool = True,
                 dkv: bool = True) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dq, dk, dv)`` in the input dtype from one P and dS (five T x T
    x D products for all three), each in the operand dtype for its
    second product; None where not asked for."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, strict)
    p, ds = _as_operand(p, q.dtype), _as_operand(ds, q.dtype)
    scale = q.shape[3] ** -0.5
    dq_ = (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
           ).to(q.dtype) if dq else None
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
          ).to(k.dtype) if dkv else None
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype) \
        if dkv else None
    return dq_, dk, dv


def flash_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = False,
                        strict: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` in the input dtype, as the dK/dV kernel."""
    return _grads_plain(q, k, v, do, lse, delta, causal, strict, dq=False)[1:]


def flash_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = False,
                       strict: bool = False) -> torch.Tensor:
    """``dq`` in the input dtype, as the dQ kernel."""
    return _grads_plain(q, k, v, do, lse, delta, causal, strict, dkv=False)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              g_lse: Optional[torch.Tensor] = None,
                              causal: bool = False, strict: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_with_lse` for the
    cotangents ``do`` (of ``o``) and ``g_lse`` (of the LSE; None is
    zero), in float32 with JAX's ``vjp_bwd`` math: P recomputed from the
    LSE, ``delta = rowsum(dO * O) - g_lse``, ``dS = P (dP - delta)``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``, ``dV = P^T dO``; results
    in the input dtype."""
    do = do.to(q.dtype)   # JAX: g.astype(in_dtype)
    delta = flash_bwd_delta_plain(o, do, g_lse)
    return _grads_plain(q, k, v, do, lse, delta, causal, strict)


# --------------------------------------------------------------------- #
# kernel launches

def _check_on_card(ref: torch.Tensor, /,
                   **tensors: Optional[torch.Tensor]) -> None:
    """Raise unless each given tensor is a CUDA tensor on ``ref``'s
    device."""
    for name, x in tensors.items():
        if x is not None and (not x.is_cuda or x.device != ref.device):
            raise ValueError(f"{name} must be a CUDA tensor on {ref.device} "
                             f"(got {x.device})")


def _strides(*xs: torch.Tensor) -> ctypes.Array:
    """The (batch, time, head) strides of each ``[B, T, H, ...]`` tensor,
    as the kernels' ``int64`` table."""
    return (ctypes.c_int64 * (3 * len(xs)))(
        *(s for x in xs for s in x.stride()[:3]))


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, strict: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: ``(o, lse)``."""
    _check_inputs(q, k, v, causal, strict)
    _check_on_card(q, q=q, k=k, v=v)
    for x in (q, k, v):
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"q, k, v must share one dtype of {_DTYPES}; "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    # the kernel walks D with unit stride and everything else by stride
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, t, h), device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v)
    with torch.cuda.device(q.device):
        rc = _lib().slt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, t, h, d, d ** -0.5,
            ctypes.cast(strides, ctypes.c_void_p), int(causal), int(strict),
            int(q.dtype == torch.bfloat16), current_stream_handle(q.device))
    check_launch(rc, NAME)
    LAUNCHES.add(NAME)
    return o, lse


def _bwd_operands(mats: Dict[str, torch.Tensor],
                  rows: Dict[str, Optional[torch.Tensor]]
                  ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """Check the backward kernels' operands: ``mats`` (q, k, v, o, dO) of
    one ``[B, T, H, D]`` shape and one dtype, ``rows`` (lse, delta,
    g_lse; None skipped) ``[B, T, H]``, all on the first one's card.
    Returns them in order, ``mats`` with unit stride along D and ``rows``
    contiguous float32."""
    ref = next(iter(mats.values()))
    _check_on_card(ref, **mats, **rows)
    if ref.dtype not in _DTYPES or any(x.dtype != ref.dtype
                                       for x in mats.values()):
        raise TypeError(f"{', '.join(mats)} must share one dtype of "
                        f"{_DTYPES}; got "
                        f"{', '.join(str(x.dtype) for x in mats.values())}")
    if ref.dim() != 4 or any(x.shape != ref.shape for x in mats.values()) \
            or any(x is not None and x.shape != ref.shape[:3]
                   for x in rows.values()):
        raise ValueError(f"{', '.join(mats)} must be one [B, T, H, D] shape "
                         f"and {', '.join(rows)} [B, T, H]")
    return ([x if x.stride(3) == 1 else x.contiguous()
             for x in mats.values()],
            [None if x is None else x.float().contiguous()
             for x in rows.values()])


def _launch_delta(o: torch.Tensor, do: torch.Tensor,
                  g_lse: Optional[torch.Tensor]) -> torch.Tensor:
    b, t, h, d = o.shape
    delta = torch.empty((b, t, h), device=o.device, dtype=torch.float32)
    strides = _strides(o, do)
    with torch.cuda.device(o.device):
        rc = _bwd_lib().slt_flash_bwd_delta(
            o.data_ptr(), do.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(),
            b, t, h, d, ctypes.cast(strides, ctypes.c_void_p),
            int(o.dtype == torch.bfloat16), current_stream_handle(o.device))
    check_launch(rc, BWD_DELTA)
    LAUNCHES.add(BWD_DELTA)
    return delta


def _launch_grads(name: str, q, k, v, do, lse, delta, causal,
                  strict) -> Tuple[torch.Tensor, ...]:
    """Launch the dK/dV (``BWD_DKV``) or dQ (``BWD_DQ``) kernel on
    checked operands: its outputs, in the input dtype."""
    fn = (_bwd_lib().slt_flash_bwd_dkv if name == BWD_DKV
          else _bwd_lib().slt_flash_bwd_dq)
    outs = tuple(torch.empty(q.shape, device=q.device, dtype=q.dtype)
                 for _ in range(2 if name == BWD_DKV else 1))
    b, t, h, d = q.shape
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                *(x.data_ptr() for x in outs), b, t, h, d, d ** -0.5,
                ctypes.cast(strides, ctypes.c_void_p), int(causal),
                int(strict), int(q.dtype == torch.bfloat16),
                current_stream_handle(q.device))
    check_launch(rc, name)
    LAUNCHES.add(name)
    return outs


def flash_bwd_delta_cuda(o: torch.Tensor, do: torch.Tensor,
                         g_lse: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the delta kernel: ``rowsum(dO * O) - g_lse``, ``[B, T, H]``
    float32 (``do`` in ``o``'s dtype; ``g_lse`` None is zero)."""
    (o, do), (g_lse,) = _bwd_operands(dict(o=o, do=do), dict(g_lse=g_lse))
    return _launch_delta(o, do, g_lse)


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = False,
                       strict: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel: ``(dk, dv)`` in the input dtype."""
    _check_inputs(q, k, v, causal, strict)
    (q, k, v, do), (lse, delta) = _bwd_operands(
        dict(q=q, k=k, v=v, do=do), dict(lse=lse, delta=delta))
    return _launch_grads(BWD_DKV, q, k, v, do, lse, delta, causal, strict)


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool = False,
                      strict: bool = False) -> torch.Tensor:
    """Launch the dQ kernel: ``dq`` in the input dtype."""
    _check_inputs(q, k, v, causal, strict)
    (q, k, v, do), (lse, delta) = _bwd_operands(
        dict(q=q, k=k, v=v, do=do), dict(lse=lse, delta=delta))
    return _launch_grads(BWD_DQ, q, k, v, do, lse, delta, causal, strict)[0]


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   g_lse: Optional[torch.Tensor] = None,
                   causal: bool = False, strict: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (delta, dK/dV, dQ): ``(dq, dk, dv)``
    in the input dtype. ``o`` and ``lse`` are the forward's outputs,
    ``do`` and ``g_lse`` their cotangents (``g_lse`` None is zero). The
    operands are checked once, for all three launches."""
    _check_inputs(q, k, v, causal, strict)
    do = do.to(q.dtype)   # JAX: g.astype(in_dtype)
    (q, k, v, o, do), (lse, g_lse) = _bwd_operands(
        dict(q=q, k=k, v=v, o=o, do=do), dict(lse=lse, g_lse=g_lse))
    delta = _launch_delta(o, do, g_lse)
    dk, dv = _launch_grads(BWD_DKV, q, k, v, do, lse, delta, causal, strict)
    (dq,) = _launch_grads(BWD_DQ, q, k, v, do, lse, delta, causal, strict)
    return dq, dk, dv


# --------------------------------------------------------------------- #
# autograd and the public entry points (the JAX package's signatures)

def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    # a meta tensor (a FLOP count's shape pass, utils/flops.step_flops)
    # takes the plain path, which computes nothing there
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")
    return False


class FlashAttentionFunction(torch.autograd.Function):
    """``(o, lse)`` with a hand-written forward (K5) and backward (K6).

    Saves q, k, v, o and the LSE, as JAX's ``vjp_fwd``; the backward
    recomputes P from them. An output that gets no cotangent adds
    nothing: ``g_lse`` is None when only ``o`` is used."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, strict: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if _on_cuda(q):
            o, lse = flash_fwd_cuda(q, k, v, causal, strict)
        else:
            _check_inputs(q, k, v, causal, strict)
            o, lse = flash_attention_with_lse_plain(q, k, v, causal, strict)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.strict = causal, strict
        return o, lse

    @staticmethod
    def backward(ctx, do: Optional[torch.Tensor],
                 g_lse: Optional[torch.Tensor]):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        bwd = flash_bwd_cuda if _on_cuda(q) else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, g_lse, ctx.causal, ctx.strict)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             strict: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, T, H, D] -> ([B, T, H, D], [B, T, H] float32)``, both
    differentiable.

    ``strict`` masks the diagonal too (row > col) and requires
    ``causal``; a fully masked row comes back as ``o = 0``,
    ``lse = NEG_BIG``."""
    return FlashAttentionFunction.apply(q, k, v, causal, strict)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise attention, ``[B, T, H, D] -> [B, T, H, D]``: a drop-in
    for :func:`split_learning_tpu_torch.ops.ring_attention.full_attention`
    with the hand-written kernels on the card."""
    return flash_attention_with_lse(q, k, v, causal)[0]


# --------------------------------------------------------------------- #
# attn="auto": dense or flash per shape (JAX's select_attention)

# The H100 speed crossover by operand size in bytes (2: bfloat16, 4:
# float32): the smallest T at which K5+K6 (forward and backward, causal,
# H 2, D 128, B*T = 65536) beat dense full_attention there and at every
# larger T measured (T 16 to 4096), from chip_smoke.py phase 33 (c)
# (PERF.md, Findings; H100 80GB HBM3, 700.00 W). Dense / flash ms:
# bf16 T 16 0.4734 / 0.4656, T 32 0.5188 / 0.2879, T 1024 3.3667 /
# 0.7833 (flash won at every T measured; at T 16 by 2%, and below 16 is
# not measured); float32 T 64 1.0004 / 1.3914, T 128 1.5649 / 1.4211,
# T 1024 8.4750 / 4.3446 (dense won at T 16-64). JAX's own constant
# (1024) was measured on a TPU and is not ported.
FLASH_SPEED_T: Dict[int, int] = {2: 16, 4: 128}
FLASH_AUTO_T_ENV = "SLT_FLASH_AUTO_T"
# JAX's memory budget where the device reports none (its CPU test
# meshes): keeps the CPU resolution equal to JAX's
_DEFAULT_MEMORY_BYTES = 16 * 1024 ** 3


def _device_memory_bytes(device: Optional[torch.device]) -> int:
    """The card's memory, or 16 GiB where the device does not say (JAX's
    ``_device_hbm_bytes``)."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return _DEFAULT_MEMORY_BYTES


def select_attention(b: int, t: int, h: int, itemsize: int,
                     hbm_bytes: Optional[int] = None,
                     t_kv: Optional[int] = None,
                     device: Optional[torch.device] = None) -> str:
    """``attn="auto"``: ``"full"`` or ``"flash"`` for one shape, by JAX's
    two rules, the one home of both (``ops/ring_attention.py`` resolves
    its ``block_impl`` here too):

    1. speed: on the card (``device`` a CUDA device), flash at or past
       :data:`FLASH_SPEED_T` for the operand size. It is off where the
       plain versions run (CPU tensors), as JAX's is off under the
       Pallas interpreter;
    2. memory: flash when dense attention's backward residuals, 3
       buffers of ``[b, h, t, t_kv]``, outgrow half the device's memory
       (``hbm_bytes``; the card's, else 16 GiB, JAX's default).

    ``SLT_FLASH_AUTO_T`` overrides both: flash at or past that T."""
    if t_kv is None:
        t_kv = t
    env = os.environ.get(FLASH_AUTO_T_ENV)
    if env:
        return "flash" if max(t, t_kv) >= int(env) else "full"
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card and itemsize in FLASH_SPEED_T \
            and max(t, t_kv) >= FLASH_SPEED_T[itemsize]:
        return "flash"
    if hbm_bytes is None:
        hbm_bytes = _device_memory_bytes(device)
    dense_resident = 3 * b * h * t * t_kv * itemsize
    return "flash" if dense_resident > hbm_bytes // 2 else "full"
