"""The split transformer (counterpart of
``split_learning_tpu/models/transformer.py``).

Same stages, parameter trees and arithmetic as the flax modules:

- split:   client(embed + N_c blocks) -> server(N_s blocks + head)
- u_split: client(embed + N_c blocks) -> server(N_s blocks)
           -> client(head)
- federated: the composition of the split plan.

``lm=True`` builds the causal language model: causal attention in every
block and a per-token head over the vocabulary, ``[B, T] -> [B, T, V]``.
Parameter names follow the flax module paths (``block0.mha.q.weight``,
``trunk.block1.ln2.weight``, ``head.lm_head.weight``, ``pos``);
:mod:`split_learning_tpu_torch.interop` maps one onto the other.

Where flax and PyTorch defaults differ, the port follows flax:

- LayerNorm epsilon is 1e-6 (PyTorch's default is 1e-5);
- GELU is the tanh approximation (PyTorch's default is exact);
- an embedding id outside ``[-vocab, vocab)`` gives a row of NaN and a
  negative id counts from the end, as ``jnp.take`` does inside
  ``nn.Embed`` (``F.embedding`` raises, and on CUDA it is a device
  assert);
- bfloat16 plans follow flax's mixed precision: parameters stay float32
  and are cast to bf16 at use (Dense inputs, kernels and biases; the
  embedding table); LayerNorm takes its statistics in float32 and
  returns bf16; the raw ``pos`` table is itself created in bf16.

Attention: ``"full"`` is the dense :func:`ops.ring_attention.full_attention`
and ``"flash"`` the hand-written kernels, K5 forward and K6 backward
(:func:`ops.flash_attention.flash_attention`). ``"ring"``,
``"ring_flash"`` and ``"ulysses"`` are the sequence-parallel forms over
``mesh``'s ``seq`` axis (:func:`ops.ring_attention.ring_attention`, its
blocks dense or chosen per shape for ``"ring"`` and on K5/K6 for
``"ring_flash"``; :func:`ops.ring_attention.ulysses_attention`); with no
``seq`` axis they run the single-device math, as JAX's do. ``"auto"``
waits for the crossover measured on the H100 and raises.

Tensor parallelism (a ``model`` axis) needs nothing of the plan: the
parameters it runs are laid out on the mesh
(:class:`~split_learning_tpu_torch.parallel.tensor.ShardedParam`) and
each op runs per rank. On such parameters the attention runs
:func:`~split_learning_tpu_torch.parallel.tensor.head_parallel_attention`:
each model rank its own heads when the ranks divide them, K5 and K6
once a rank and block. ``"full"`` and ``"flash"`` take a ``model``
axis; the sequence-parallel forms do not (a ``model`` and a ``seq``
axis together: ROADMAP item 18.2). :data:`TP_HEAVY_PARAMS` names the
layers whose weights the rule must shard, as JAX's does.

KV-cache decode (:mod:`runtime.generate`): ``cache_len=L`` (prefill)
also returns per-block ``{"k", "v"}`` buffers of length ``L``;
``decode_cache=``/``pos=`` runs tokens at ``pos`` against the caches.
Unlike JAX's functional ``dynamic_update_slice``, the decode step writes
the new keys and values into the cache tensors **in place** and returns
the same tensors.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_tpu_torch.core.stage import SplitPlan, Stage
from split_learning_tpu_torch.ops.flash_attention import flash_attention
from split_learning_tpu_torch.ops.ring_attention import (
    full_attention, ring_attention, ulysses_attention)
from split_learning_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS
from split_learning_tpu_torch.parallel.tensor import (
    head_parallel_attention, is_sharded)

_META = "meta"  # stage modules describe shapes only; params live outside
_ATTN_IMPLS = ("full", "flash", "auto", "ring", "ring_flash", "ulysses")
LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon
EMBED_LAYERS = ("tok",)  # interop: these layers' 2-D ``weight`` is a table
# the layers whose weights tensor parallelism must shard (JAX's list): a
# layout that leaves one of them replicated fails the layout test
TP_HEAVY_PARAMS = ("q", "k", "v", "out", "up", "down", "fc", "lm_head")

Cache = Optional[dict]


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 parameters; input, kernel and
    bias cast to ``dtype`` at use."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype) -> None:
        super().__init__(fan_in, fan_out, device=_META)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: epsilon 1e-6, statistics in
    float32, the output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype) -> None:
        super().__init__(features, eps=LN_EPS, device=_META)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.compute_dtype)


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=...)``: the table cast to ``dtype``; ids
    gathered as ``jnp.take`` does (negative ids count from the end, ids
    outside ``[-vocab, vocab)`` give NaN rows)."""

    def __init__(self, vocab: int, features: int, dtype: torch.dtype) -> None:
        super().__init__(vocab, features, device=_META)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.is_floating_point() or ids.is_complex():
            raise ValueError("Input type must be an integer or unsigned "
                             "integer.")
        n = self.num_embeddings
        ids = ids.long()
        ids = torch.where(ids < 0, ids + n, ids)
        valid = (ids >= 0) & (ids < n)
        out = F.embedding(ids.clamp(0, n - 1),
                          self.weight.to(self.compute_dtype))
        return out.masked_fill(~valid.unsqueeze(-1), float("nan"))


def _decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Queries ``[B, t, H, D]`` against the cache's live prefix
    ``[B, L', H, D]`` in float32, cast to the cache dtype. JAX masks the
    keys past ``pos`` to NEG_BIG, whose exp is exactly 0; the port leaves
    them out. Dense math: a decode step is one row of scores."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, cv.float()).to(cv.dtype)


class MultiHeadAttention(nn.Module):
    """Projections + attention (dense or the flash kernel), with the
    KV-cache modes."""

    def __init__(self, d_model: int, num_heads: int, attn: str, causal: bool,
                 dtype: torch.dtype, mesh: Any = None) -> None:
        super().__init__()
        self.num_heads, self.attn, self.causal = num_heads, attn, causal
        self.mesh = mesh
        self.q = Dense(d_model, d_model, dtype)
        self.k = Dense(d_model, d_model, dtype)
        self.v = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """The attention of ``[B, T, H, D]`` heads, by ``attn``."""
        if self.attn == "ring":
            return ring_attention(q, k, v, mesh=self.mesh,
                                  causal=self.causal)
        if self.attn == "ring_flash":
            return ring_attention(q, k, v, mesh=self.mesh,
                                  causal=self.causal, block_impl="flash")
        if self.attn == "ulysses":
            return ulysses_attention(q, k, v, mesh=self.mesh,
                                     causal=self.causal)
        if self.attn == "flash":
            return flash_attention(q, k, v, causal=self.causal)
        return full_attention(q, k, v, causal=self.causal)

    def forward(self, x: torch.Tensor, *, cache_len: int = 0,
                decode_cache: Cache = None, pos: Optional[int] = None):
        b, t, e = x.shape
        if e % self.num_heads != 0:
            raise ValueError(f"d_model {e} % heads {self.num_heads} != 0")
        d = e // self.num_heads
        heads = (b, t, self.num_heads, d)
        if (is_sharded(self.q.weight) and not cache_len
                and decode_cache is None):
            o = head_parallel_attention(x, (self.q, self.k, self.v),
                                        self.num_heads, self._attend)
            return self.out(o.reshape(b, t, e))
        q = self.q(x).reshape(heads)
        k = self.k(x).reshape(heads)
        v = self.v(x).reshape(heads)
        if decode_cache is not None:
            ck, cv = decode_cache["k"], decode_cache["v"]
            if not 0 <= pos <= ck.shape[1] - t:
                raise ValueError(f"pos {pos} outside the cache of length "
                                 f"{ck.shape[1]}")
            ck[:, pos:pos + t] = k   # in place (JAX: dynamic_update_slice)
            cv[:, pos:pos + t] = v
            o = _decode_attention(q, ck[:, :pos + 1], cv[:, :pos + 1],
                                  d ** -0.5)
            return self.out(o.reshape(b, t, e)), {"k": ck, "v": cv}
        out = self.out(self._attend(q, k, v).reshape(b, t, e))
        if cache_len:
            if cache_len < t:
                raise ValueError(f"cache_len {cache_len} < sequence {t}")
            ck = k.new_zeros((b, cache_len) + heads[2:])
            cv = v.new_zeros((b, cache_len) + heads[2:])
            ck[:, :t] = k
            cv[:, :t] = v
            return out, {"k": ck, "v": cv}
        return out


class Block(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, d_model: int, num_heads: int, attn: str, causal: bool,
                 dtype: torch.dtype, mlp_ratio: int = 4,
                 mesh: Any = None) -> None:
        super().__init__()
        self.mha = MultiHeadAttention(d_model, num_heads, attn, causal, dtype,
                                      mesh)
        self.ln1 = LayerNorm(d_model, dtype)
        self.ln2 = LayerNorm(d_model, dtype)
        self.up = Dense(d_model, mlp_ratio * d_model, dtype)
        self.down = Dense(mlp_ratio * d_model, d_model, dtype)

    def forward(self, x: torch.Tensor, *, cache_len: int = 0,
                decode_cache: Cache = None, pos: Optional[int] = None):
        caching = bool(cache_len) or decode_cache is not None
        if caching:
            h, cache = self.mha(self.ln1(x), cache_len=cache_len,
                                decode_cache=decode_cache, pos=pos)
        else:
            h = self.mha(self.ln1(x))
        x = x + h
        y = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        out = x + self.down(y)
        return (out, cache) if caching else out


def _make_blocks(owner: nn.Module, depth: int, **kw: Any) -> None:
    for i in range(depth):
        owner.add_module(f"block{i}", Block(**kw))


def _thread_blocks(owner: nn.Module, depth: int, x: torch.Tensor,
                   cache_len: int, decode_cache: Optional[Sequence[dict]],
                   pos: Optional[int]):
    """Run ``x`` through ``owner.block0..``, threading per-block KV caches
    when a cache mode is active."""
    caching = bool(cache_len) or decode_cache is not None
    caches = []
    for i in range(depth):
        blk = getattr(owner, f"block{i}")
        if caching:
            x, c = blk(x, cache_len=cache_len, pos=pos,
                       decode_cache=(decode_cache[i]
                                     if decode_cache is not None else None))
            caches.append(c)
        else:
            x = blk(x)
    return (x, tuple(caches)) if caching else x


class EmbedStage(nn.Module):
    """Client bottom stage: token + learned positional embeddings, then
    ``depth`` blocks. ``[B, T] int -> [B, T, d_model]`` (the cut tensor)."""

    def __init__(self, vocab: int, d_model: int, num_heads: int, depth: int,
                 max_len: int, attn: str, causal: bool,
                 dtype: torch.dtype, mesh: Any = None) -> None:
        super().__init__()
        self.depth, self.max_len, self.d_model = depth, max_len, d_model
        self.tok = Embed(vocab, d_model, dtype)
        self.pos = nn.Parameter(torch.empty(max_len, d_model, dtype=dtype,
                                            device=_META))
        _make_blocks(self, depth, d_model=d_model, num_heads=num_heads,
                     attn=attn, causal=causal, dtype=dtype, mesh=mesh)

    def forward(self, tokens: torch.Tensor, *, cache_len: int = 0,
                decode_cache: Optional[Sequence[dict]] = None,
                pos: Optional[int] = None):
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} > max_len {self.max_len}")
        if cache_len > self.max_len:
            raise ValueError(f"cache_len {cache_len} > max_len "
                             f"{self.max_len}")
        x = self.tok(tokens)
        if decode_cache is not None:
            x = x + self.pos[pos:pos + 1][None]   # one token at position pos
        else:
            x = x + self.pos[None, :t]
        return _thread_blocks(self, self.depth, x, cache_len, decode_cache,
                              pos)


class TrunkStage(nn.Module):
    """Server middle stage: ``depth`` blocks, ``[B, T, E] -> [B, T, E]``."""

    def __init__(self, d_model: int, num_heads: int, depth: int, attn: str,
                 causal: bool, dtype: torch.dtype, mesh: Any = None) -> None:
        super().__init__()
        self.depth = depth
        _make_blocks(self, depth, d_model=d_model, num_heads=num_heads,
                     attn=attn, causal=causal, dtype=dtype, mesh=mesh)

    def forward(self, x: torch.Tensor, *, cache_len: int = 0,
                decode_cache: Optional[Sequence[dict]] = None,
                pos: Optional[int] = None):
        return _thread_blocks(self, self.depth, x, cache_len, decode_cache,
                              pos)


class HeadStage(nn.Module):
    """Final LN -> mean-pool over T -> Dense(num_classes)."""

    def __init__(self, d_model: int, num_classes: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.ln_f = LayerNorm(d_model, dtype)
        self.fc = Dense(d_model, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.ln_f(x).mean(dim=1))


class LMHeadStage(nn.Module):
    """Causal-LM head: LN -> per-token Dense(vocab), ``[B, T, E] ->
    [B, T, vocab]``. Stateless: the cache keywords exist so the decode
    driver can thread every stage alike (its cache is empty)."""

    def __init__(self, d_model: int, vocab: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.ln_f = LayerNorm(d_model, dtype)
        self.lm_head = Dense(d_model, vocab, dtype)

    def forward(self, x: torch.Tensor, *, cache_len: int = 0,
                decode_cache: Any = None, pos: Optional[int] = None):
        y = self.lm_head(self.ln_f(x))
        return (y, ()) if (cache_len or decode_cache is not None) else y


class TrunkAndHead(nn.Module):
    """Server top stage of the 2-party split: trunk + head in one stage."""

    def __init__(self, d_model: int, num_heads: int, depth: int,
                 num_classes: int, attn: str, causal: bool, lm_vocab: int,
                 dtype: torch.dtype, mesh: Any = None) -> None:
        super().__init__()
        self.lm_vocab = lm_vocab
        self.trunk = TrunkStage(d_model, num_heads, depth, attn, causal,
                                dtype, mesh)
        self.head = (LMHeadStage(d_model, lm_vocab, dtype) if lm_vocab
                     else HeadStage(d_model, num_classes, dtype))

    def forward(self, x: torch.Tensor, *, cache_len: int = 0,
                decode_cache: Optional[Sequence[dict]] = None,
                pos: Optional[int] = None):
        if cache_len or decode_cache is not None:
            if not self.lm_vocab:
                raise ValueError("KV-cache decode requires the causal-LM "
                                 "head (lm=True plans)")
            x, caches = self.trunk(x, cache_len=cache_len,
                                   decode_cache=decode_cache, pos=pos)
            return self.head(x), caches
        return self.head(self.trunk(x))


def check_attn(attn: str, mesh: Any = None) -> None:
    """Every attention form but ``"auto"`` runs. An unknown name raises
    ``ValueError`` (JAX's); ``"auto"``, a mesh with both a ``model`` and
    a ``seq`` axis, and a sequence-parallel form on a ``model`` axis
    raise ``NotImplementedError``."""
    if attn not in _ATTN_IMPLS:
        raise ValueError(
            f"Unknown attn impl: {attn!r} (expected {_ATTN_IMPLS})")
    if attn == "auto":
        raise NotImplementedError(
            "attn='auto' picks dense or flash by a crossover measured on the "
            "card; the H100 crossover is not measured yet (ROADMAP), so "
            "choose 'full' or 'flash'")
    if mesh is not None and MODEL_AXIS in mesh.axis_names and (
            SEQ_AXIS in mesh.axis_names or attn not in ("full", "flash")):
        raise NotImplementedError(
            "not ported yet: a model axis with context parallelism (a "
            "seq axis or a sequence-parallel attn; ROADMAP item 18.2)")


def transformer_plan(mode: str = "split", dtype: torch.dtype = torch.float32,
                     *, vocab: int = 256, d_model: int = 64,
                     num_heads: int = 4, client_depth: int = 1,
                     server_depth: int = 2, num_classes: int = 10,
                     max_len: int = 2048, mesh: Any = None,
                     attn: str = "full", causal: bool = False,
                     lm: bool = False) -> SplitPlan:
    """Build the split-transformer :class:`SplitPlan` for ``mode``.

    ``dtype`` is ``torch.float32`` or ``torch.bfloat16``. ``mesh`` is
    the device mesh whose ``seq`` axis the ring and Ulysses forms shard
    over."""
    check_attn(attn, mesh)
    causal = causal or lm
    common = dict(attn=attn, causal=causal, dtype=dtype, mesh=mesh)
    embed = Stage("embed", EmbedStage(vocab, d_model, num_heads,
                                      client_depth, max_len, **common))
    if mode == "u_split":
        head = (LMHeadStage(d_model, vocab, dtype) if lm
                else HeadStage(d_model, num_classes, dtype))
        return SplitPlan(
            stages=(embed,
                    Stage("trunk", TrunkStage(d_model, num_heads,
                                              server_depth, **common)),
                    Stage("head", head)),
            owners=("client", "server", "client"))
    # split and federated share the 2-stage plan
    return SplitPlan(
        stages=(embed,
                Stage("trunk_head", TrunkAndHead(
                    d_model, num_heads, server_depth, num_classes,
                    lm_vocab=vocab if lm else 0, **common))),
        owners=("client", "server"))

