"""Autoregressive generation for the causal-LM plans (counterpart of
``split_learning_tpu/runtime/generate.py``).

Two decode schemes, as in the JAX package:

- **KV-cache decode (the default)**: the prefill runs the prompt once
  through every stage with ``cache_len=total``, so each attention layer
  returns its K/V buffers (on the card the prompt's attention is the
  flash kernel, one launch per block); each generated token is then one
  single-position step against the caches (``decode_cache=``/``pos=``),
  which the port updates in place.
- **Re-forward decode** (``kv_cache=False``): each step re-runs the whole
  plan on a fixed-size token buffer; the causal mask keeps the unwritten
  positions inert.
- **Split-party decode** (:func:`generate_remote`): the re-forward
  scheme with the server's stage behind ``transport.predict``, one round
  trip per token.

Where JAX compiles one scan per (plan, shape), the port runs a Python
loop, eagerly, under ``torch.no_grad()``. Greedy decoding is JAX's
argmax token for token. Sampling applies JAX's filters in JAX's order
(temperature, then top-k, then top-p) and draws the categorical by the
Gumbel-max rule from a caller-seeded ``torch.Generator``: the same seed
gives the same tokens, but not JAX's, whose PRNG differs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.ops.common import NEG_BIG
from split_learning_tpu_torch.runtime.evaluate import split_client_stages
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device

Pick = Callable[[torch.Tensor], torch.Tensor]


def _greedy(dtype: torch.dtype) -> Pick:
    return lambda row: torch.argmax(row, dim=-1).to(dtype)


def _sampler(dtype: torch.dtype, generator: torch.Generator,
             temperature: float, top_k: int, top_p: float) -> Pick:
    """Token chooser for one logits row ``[B, V]``: the filters apply to
    the temperature-scaled logits, largest first."""

    def pick(row: torch.Tensor) -> torch.Tensor:
        if top_k > row.shape[-1]:
            raise ValueError(f"top_k={top_k} exceeds the vocabulary "
                             f"size {row.shape[-1]}")
        scaled = row.float() / temperature
        if top_k > 0:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, NEG_BIG, scaled)
        if top_p < 1.0:
            # nucleus: keep the smallest prefix of descending-probability
            # tokens whose mass reaches top_p (the first always stays)
            sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
            probs = torch.softmax(sorted_desc, dim=-1)
            cum_before = torch.cumsum(probs, dim=-1) - probs
            cutoff = torch.where(cum_before < top_p, sorted_desc,
                                 float("inf")).amin(dim=-1, keepdim=True)
            scaled = torch.where(scaled < cutoff, NEG_BIG, scaled)
        u = torch.rand(scaled.shape, generator=generator,
                       device=generator.device).to(scaled.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
        return torch.argmax(scaled + gumbel, dim=-1).to(dtype)

    return pick


def _prompt_on(prompt, device: torch.device) -> torch.Tensor:
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.asarray(prompt))
    return prompt.to(device)


def _check_params(params: Sequence[Params], device: torch.device) -> None:
    for stage in params:
        for name, t in stage.items():
            if t.device.type != device.type or (
                    device.index is not None and t.device.index != device.index):
                raise ValueError(
                    f"parameter {name!r} lies on {t.device}, not on the "
                    f"requested device {device}; move the params first")


@torch.no_grad()
def _decode(plan: SplitPlan, params: Sequence[Params], prompt: torch.Tensor,
            n_new: int, kv_cache: bool, pick: Pick) -> torch.Tensor:
    b, p = prompt.shape
    total = p + n_new
    if not kv_cache:
        buf = prompt.new_zeros((b, total))
        buf[:, :p] = prompt
        for pos in range(p - 1, total - 1):
            # pos is the last written token; its logits predict the next
            logits = plan.apply(params, buf)
            buf[:, pos + 1] = pick(logits[:, pos, :])
        return buf
    # prefill: the prompt once through every stage; caches sized for the
    # whole decode up front
    x, caches = prompt, []
    for st, pr in zip(plan.stages, params):
        x, c = st.apply(pr, x, cache_len=total)
        caches.append(c)
    tok = pick(x[:, p - 1, :])          # the token at index p
    out = [prompt, tok[:, None]]
    for pos in range(p, total - 1):
        # the step at pos writes `tok` into the caches at index pos and
        # emits the token for index pos + 1
        x = tok[:, None]
        for st, pr, c in zip(plan.stages, params, caches):
            x, _ = st.apply(pr, x, decode_cache=c, pos=pos)
        tok = pick(x[:, 0, :])
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def greedy_generate(plan: SplitPlan, params: Sequence[Params], prompt,
                    n_new: int, *, kv_cache: bool = True,
                    device: DeviceLike = "cuda") -> torch.Tensor:
    """Extend ``prompt`` ``[B, P] int`` by ``n_new`` greedy tokens.

    Returns ``[B, P + n_new]`` on ``device``, in the prompt's dtype. The
    plan must produce per-token logits (an ``lm=True`` transformer plan)
    and ``params`` must already lie on ``device``. ``kv_cache=False``
    selects the O(T^2) re-forward path."""
    dev = resolve_device(device)
    prompt = _prompt_on(prompt, dev)
    if n_new <= 0:
        if n_new < 0:
            raise ValueError(f"n_new must be >= 0 (got {n_new})")
        return prompt
    _check_params(params, dev)
    return _decode(plan, params, prompt, n_new, kv_cache,
                   _greedy(prompt.dtype))


def sample_generate(plan: SplitPlan, params: Sequence[Params], prompt,
                    n_new: int, rng: torch.Generator,
                    temperature: float = 1.0, *, top_k: int = 0,
                    top_p: float = 1.0, kv_cache: bool = True,
                    device: DeviceLike = "cuda") -> torch.Tensor:
    """Like :func:`greedy_generate` but samples from the softmax at
    ``temperature``, after keeping only the ``top_k`` best tokens (0:
    all) and then the smallest prefix of descending-probability tokens
    whose mass reaches ``top_p`` (1.0: all). ``rng`` is a
    ``torch.Generator`` on the CPU or on ``device``; ``temperature`` must
    be > 0 (use :func:`greedy_generate` for deterministic decoding)."""
    if not temperature > 0.0:  # also rejects NaN, which `<= 0` lets past
        raise ValueError(
            f"temperature must be > 0 (got {temperature}); use "
            "greedy_generate for deterministic decoding")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (got {top_k})")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1] (got {top_p})")
    dev = resolve_device(device)
    prompt = _prompt_on(prompt, dev)
    if n_new <= 0:
        if n_new < 0:
            raise ValueError(f"n_new must be >= 0 (got {n_new})")
        return prompt
    _check_params(params, dev)
    pick = _sampler(prompt.dtype, rng, temperature, top_k, top_p)
    return _decode(plan, params, prompt, n_new, kv_cache, pick)


def generate_remote(plan: SplitPlan, client_params: Sequence[Params],
                    transport, prompt, n_new: int,
                    rng: Optional[torch.Generator] = None,
                    temperature: float = 1.0, *, top_k: int = 0,
                    top_p: float = 1.0,
                    device: DeviceLike = "cuda") -> np.ndarray:
    """Split-party autoregressive decode: the client holds only its own
    stages (``client_params``, ordered as ``plan.stages_of("client")``)
    and picks the tokens; the server's stage runs behind
    ``transport.predict``, one forward-only round trip per generated
    token. Greedy when ``rng`` is None (the sampling knobs must then stay
    at their defaults: passing them without an ``rng`` is an error, never
    a silent greedy decode); otherwise :func:`sample_generate`'s
    temperature/top-k/top-p sampling from the ``torch.Generator``.

    The re-forward scheme over a fixed ``[B, P + n_new]`` buffer, as in
    JAX: each hop carries the pre-cut activations of the whole buffer, as
    tensors on ``device`` (so a compressing transport encodes them on the
    card); a reply that comes back as numpy (a JAX peer) is moved there.
    ``client_params`` must lie on ``device``. Returns the tokens as numpy
    ``[B, P + n_new]``, token-exact against the local re-forward decode."""
    if not temperature > 0.0:  # also rejects NaN, which `<= 0` lets past
        raise ValueError(f"temperature must be > 0 (got {temperature})")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (got {top_k})")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1] (got {top_p})")
    if rng is None and (temperature != 1.0 or top_k or top_p != 1.0):
        raise ValueError(
            "sampling knobs (temperature/top_k/top_p) require rng; "
            "omit them for greedy decoding")
    if n_new <= 0:
        if n_new < 0:
            raise ValueError(f"n_new must be >= 0 (got {n_new})")
        return np.asarray(prompt)
    dev = resolve_device(device)
    pre_stages, pre_params, post_stages, post_params = \
        split_client_stages(plan, client_params)
    _check_params(client_params, dev)
    prompt = _prompt_on(prompt, dev)
    pick = (_greedy(prompt.dtype) if rng is None else
            _sampler(prompt.dtype, rng, temperature, top_k, top_p))
    b, p = prompt.shape
    total = p + n_new
    buf = prompt.new_zeros((b, total))
    buf[:, :p] = prompt
    with torch.no_grad():
        for pos in range(p - 1, total - 1):
            x = buf
            for st, pr in zip(pre_stages, pre_params):
                x = st.apply(pr, x)
            logits = torch.as_tensor(transport.predict(x)).to(dev)
            for st, pr in zip(post_stages, post_params):
                logits = st.apply(pr, logits)
            buf[:, pos + 1] = pick(logits[:, pos, :])
    return buf.cpu().numpy()
