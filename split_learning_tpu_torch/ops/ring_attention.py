"""Dense attention and the sequence-parallel forms
(counterpart of ``split_learning_tpu/ops/ring_attention.py``).

:func:`full_attention` is the JAX package's single-device reference
semantics in plain PyTorch, computed in the input dtype as there.

The two parallel forms shard the sequence of ``[B, T, H, D]`` over the
``seq`` axis of a :class:`~split_learning_tpu_torch.parallel.mesh.Mesh`
(the batch over its ``data`` rows), run each rank's share on the rank's
device, and gather the output back to the caller's device. JAX's
``shard_map`` bodies become loops over the ranks:

- **Ring attention** (:func:`ring_attention`): each rank keeps its
  query block and the K/V blocks rotate around the ring, one hop a step
  (JAX's ``ppermute`` is a ``.to`` of each block onto the next rank's
  device). The per-block math is the dense online softmax
  (``block_impl="dense"``) or the flash kernels (``"flash"``: K5 on
  every (query block, rotated K/V block) pair, merged in log space, and
  K6 in the backward with the LSE's cotangent).
- **Ulysses attention** (:func:`ulysses_attention`): two all-to-all
  transposes (a split and a ``torch.cat`` across ranks) turn sequence
  shards into head shards and back; each rank attends over the whole
  sequence for ``H / n`` heads, dense or on K5/K6.

Autograd differentiates through the device copies and the merge, as
JAX's transpose does. The fused trainer's step hands the forms
:class:`~split_learning_tpu_torch.parallel.tensor.SeqBlocks`, its
activations already partitioned along T, and they run on the blocks
where they lie and return blocks. A plain tensor, called outside such a
step, is scattered over the ranks and gathered back (``_sharded``):
inside :func:`~split_learning_tpu_torch.parallel.mesh.data_row` as that
data row's, over that row's ``seq`` devices only; otherwise its batch
split over the data rows as JAX's ``shard_map`` does.
:func:`seq_local_attention` is ``"full"`` and ``"flash"`` on blocks.
``block_impl="auto"`` resolves through the port's
:func:`~split_learning_tpu_torch.ops.flash_attention.select_attention`.
With virtual ranks on one card every rank is the same device and the
copies are no-ops; the launches are those of n ranks.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.ops.common import NEG_BIG
from split_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, SEQ_AXIS, Mesh, active_row)
from split_learning_tpu_torch.parallel.tensor import (
    SeqBlocks, gather, restripe, scatter)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """Plain dense softmax attention, ``[B, T, H, D] -> [B, T, H, D]``.
    ``q_offset``: the queries' first position among the keys' (a causal
    query block of a longer sequence)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(q_offset, q_offset + tq,
                             device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# --------------------------------------------------------------------- #
# per-rank bodies: lists of one tensor a seq rank, each on its device

Blocks = List[torch.Tensor]


def _rotate(blocks: Blocks, devs: Sequence[torch.device]) -> Blocks:
    """One ring hop: rank r's block moves to rank r + 1 (JAX's
    ``ppermute`` with ``perm = [(j, (j + 1) % n)]``)."""
    n = len(blocks)
    return [blocks[(r - 1) % n].to(devs[r]) for r in range(n)]


def _ring_dense(qs: Blocks, ks: Blocks, vs: Blocks,
                devs: Sequence[torch.device], causal: bool,
                striped: bool) -> Blocks:
    """JAX's ``_ring_attention_local`` on every rank: the online softmax
    (running max ``m``, denominator ``l``, accumulator ``o``) in float32
    over the n rotated K/V blocks; the output cast to the input dtype.

    ``striped``: token j of rank r is global position ``j*n + r``
    (:func:`stripe_permutation`), else ``r*t_local + j``."""
    n = len(qs)
    b, t_local, h, d = qs[0].shape
    scale = d ** -0.5

    def positions(r: int, dev: torch.device) -> torch.Tensor:
        idx = torch.arange(t_local, device=dev)
        return idx * n + r if striped else r * t_local + idx

    state = []
    for r in range(n):
        dev = qs[r].device
        state.append([torch.zeros((b, h, t_local, d), device=dev),
                      torch.zeros((b, h, t_local), device=dev),
                      torch.full((b, h, t_local), NEG_BIG, device=dev)])
    kb, vb = list(ks), list(vs)
    for i in range(n):
        for r in range(n):
            o, l, m = state[r]
            q = qs[r]
            src = (r - i) % n
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                             kb[r].float()) * scale
            mask = None
            if causal:
                mask = (positions(r, q.device)[:, None]
                        >= positions(src, q.device)[None, :])
                s = torch.where(mask, s, torch.full_like(s, NEG_BIG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # masked entries are re-zeroed after the exp:
            # exp(NEG_BIG - NEG_BIG) would be 1
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb[r].float())
            state[r] = [o, l, m_new]
        if i < n - 1:   # n - 1 hops; a 1-rank ring never moves
            kb, vb = _rotate(kb, devs), _rotate(vb, devs)
    return [(o / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
            for (o, l, _), q in zip(state, qs)]


def _merge(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
           lse2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two normalized partials ``(o, lse)`` merged exactly in log space,
    in float32 (``o2`` arrives in the input dtype)."""
    m = torch.maximum(lse1, lse2)
    a1 = torch.exp(lse1 - m)
    a2 = torch.exp(lse2 - m)
    denom = a1 + a2
    o = (o1 * a1[..., None] + o2.float() * a2[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _ring_flash(qs: Blocks, ks: Blocks, vs: Blocks,
                devs: Sequence[torch.device], causal: bool,
                striped: bool) -> Blocks:
    """JAX's ``_ring_flash_local`` on every rank: each (query block,
    rotated K/V block) pair runs :func:`~split_learning_tpu_torch.ops.
    flash_attention.flash_attention_with_lse` (K5 on the card, K6 in its
    backward), the partials merged by :func:`_merge`.

    Masks of a causal hop from source rank ``src``: striped, ``src <=
    rank`` is causal and ``src > rank`` strict causal (the diagonal too);
    contiguous, past ranks are unmasked, the diagonal block causal, and
    future blocks contribute ``(0, NEG_BIG)`` with no launch."""
    from split_learning_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse)

    n = len(qs)
    b, t_local, h, d = qs[0].shape

    def block(r: int, kb: torch.Tensor, vb: torch.Tensor, i: int):
        q = qs[r]
        if not causal:
            return flash_attention_with_lse(q, kb, vb, causal=False)
        src = (r - i) % n
        if striped:
            return flash_attention_with_lse(q, kb, vb, causal=True,
                                            strict=src > r)
        if src < r:
            return flash_attention_with_lse(q, kb, vb, causal=False)
        if src == r:
            return flash_attention_with_lse(q, kb, vb, causal=True)
        return (torch.zeros((b, t_local, h, d), dtype=q.dtype,
                            device=q.device),
                torch.full((b, t_local, h), NEG_BIG, device=q.device))

    state = [(torch.zeros((b, t_local, h, d), device=q.device),
              torch.full((b, t_local, h), NEG_BIG, device=q.device))
             for q in qs]
    kb, vb = list(ks), list(vs)
    for i in range(n):
        for r in range(n):
            state[r] = _merge(*state[r], *block(r, kb[r], vb[r], i))
        if i < n - 1:
            kb, vb = _rotate(kb, devs), _rotate(vb, devs)
    return [o.to(q.dtype) for (o, _), q in zip(state, qs)]


def _ulysses(qs: Blocks, ks: Blocks, vs: Blocks,
             devs: Sequence[torch.device], causal: bool,
             use_flash: bool) -> Blocks:
    """JAX's ``_ulysses_local`` on every rank: all-to-all sequence ->
    heads, attention over the whole sequence for ``H / n`` heads (dense
    or K5/K6), heads -> sequence."""
    n = len(qs)
    h = qs[0].shape[2]
    if h % n != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the seq axis size "
            f"({n}); use ring_attention for odd head counts")
    hn = h // n

    def gather(xs: Blocks) -> Blocks:
        # rank r: every rank's sequence shard of head group r
        return [torch.cat([x[:, :, r * hn:(r + 1) * hn].to(devs[r])
                           for x in xs], dim=1) for r in range(n)]

    qg, kg, vg = gather(qs), gather(ks), gather(vs)
    if use_flash:
        from split_learning_tpu_torch.ops.flash_attention import (
            flash_attention)
        attend: Callable = flash_attention
    else:
        attend = full_attention
    og = [attend(q, k, v, causal=causal) for q, k, v in zip(qg, kg, vg)]
    t_local = qs[0].shape[1]
    # rank s: its sequence shard of every head group
    return [torch.cat([o[:, s * t_local:(s + 1) * t_local].to(devs[s])
                       for o in og], dim=2) for s in range(n)]


def _sharded(mesh: Mesh, axis_name: str, body: Callable, q: torch.Tensor,
             k: torch.Tensor, v: torch.Tensor, causal: bool,
             **body_kw) -> torch.Tensor:
    """JAX's ``shard_map`` of ``body`` with specs ``[data, axis, -, -]``:
    the batch over the data rows (only the active row's, inside
    :func:`~split_learning_tpu_torch.parallel.mesh.data_row`), the
    sequence over ``axis_name``; the output on ``q``'s device."""
    row = active_row(mesh)
    n_data = mesh.shape.get(DATA_AXIS, 1)
    rows = [row] if row is not None else list(range(n_data))
    n = mesh.shape[axis_name]
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} does not divide "
                         f"over the {axis_name!r} axis ({n})")
    if q.shape[0] % len(rows):
        raise ValueError(f"batch {q.shape[0]} does not divide over "
                         f"{len(rows)} data rows")
    outs = []
    for d, qb, kb, vb in zip(rows, *(x.chunk(len(rows), 0)
                                     for x in (q, k, v))):
        coords = {DATA_AXIS: d} if DATA_AXIS in mesh.axis_names else {}
        devs = mesh.axis_devices(axis_name, **coords)
        if q.is_meta:   # a FLOP count's shape pass stays on meta
            devs = [q.device] * n
        split = [[c.to(dev) for c, dev in zip(x.chunk(n, 1), devs)]
                 for x in (qb, kb, vb)]
        parts = body(*split, devs, causal, **body_kw)
        outs.append(torch.cat([p.to(q.device) for p in parts], dim=1))
    return torch.cat(outs, 0) if len(outs) > 1 else outs[0]


def _on_blocks(body: Callable, q: SeqBlocks, k: SeqBlocks, v: SeqBlocks,
               causal: bool, **body_kw) -> SeqBlocks:
    """``body`` on T-partitioned blocks where they already lie: no
    scatter before and no gather after."""
    return SeqBlocks(body(q.blocks, k.blocks, v.blocks, q.devs, causal,
                          **body_kw), q.devs)


def seq_local_attention(q: SeqBlocks, k: SeqBlocks, v: SeqBlocks,
                        causal: bool = False,
                        use_flash: bool = False) -> SeqBlocks:
    """``"full"`` or ``"flash"`` attention on T-partitioned blocks (a
    plan built with a ``seq`` mesh and no sequence-parallel form), as
    JAX's GSPMD partitions them. Dense: every rank gathers the whole K
    and V and attends its own queries (:func:`full_attention` with the
    block's offset). Flash: q, k and v are gathered onto the first rank,
    K5/K6 run once over the whole T and the output is scattered back (a
    Pallas call is one op GSPMD does not partition either)."""
    if use_flash:
        from split_learning_tpu_torch.ops.flash_attention import (
            flash_attention)
        whole = [gather(x.blocks, 1, q.devs[0]) for x in (q, k, v)]
        o = flash_attention(*whole, causal=causal)
        return SeqBlocks(scatter(o, 1, q.devs), q.devs)
    out = []
    for r, (qb, dev) in enumerate(zip(q.blocks, q.devs)):
        kw = torch.cat([b.to(dev) for b in k.blocks], 1)
        vw = torch.cat([b.to(dev) for b in v.blocks], 1)
        out.append(full_attention(qb, kw, vw, causal=causal,
                                  q_offset=r * q.t_local))
    return SeqBlocks(out, q.devs)


# --------------------------------------------------------------------- #
# block_impl="auto": the port's select_attention (ops/flash_attention.py)

def _resolve_block_impl(block_impl: str, b: int, t_q: int, t_kv: int,
                        h: int, itemsize: int,
                        device: torch.device = torch.device("cpu")) -> str:
    """``"auto"``: :func:`~split_learning_tpu_torch.ops.flash_attention.
    select_attention` on one rank's shapes (its speed rule on the card,
    its memory rule, ``SLT_FLASH_AUTO_T``), as JAX's resolves through
    its own ``select_attention``."""
    if block_impl != "auto":
        return block_impl
    from split_learning_tpu_torch.ops.flash_attention import (
        select_attention)
    choice = select_attention(b, t_q, h, itemsize, t_kv=t_kv, device=device)
    return "flash" if choice == "flash" else "dense"


def _check_impl(form: str, block_impl: str) -> None:
    if block_impl not in ("dense", "flash", "auto"):
        raise ValueError(f"Unknown {form} block_impl: {block_impl!r} "
                         "(expected 'dense', 'flash' or 'auto')")


def _single_device(q, k, v, causal, block_impl) -> torch.Tensor:
    """No ``seq`` axis: the single-device math ``block_impl`` picks."""
    b, t, h, _ = q.shape
    impl = _resolve_block_impl(block_impl, b, t, t, h, q.element_size(),
                               q.device)
    if impl == "flash":
        from split_learning_tpu_torch.ops.flash_attention import (
            flash_attention)
        return flash_attention(q, k, v, causal=causal)
    return full_attention(q, k, v, causal=causal)


def _rows_batch(mesh: Mesh, b: int) -> int:
    """The batch one rank sees: all of ``b`` inside a data row, else its
    share of the data rows (JAX's ``b // data or 1``)."""
    if active_row(mesh) is not None:
        return b
    return b // mesh.shape.get(DATA_AXIS, 1) or 1


def stripe_permutation(t: int, n: int) -> np.ndarray:
    """Index permutation from natural token order to the striped ring
    layout: shard r's contiguous slot holds tokens r, r+n, ...
    ``x[:, stripe_permutation(T, n)]`` stripes; ``np.argsort`` of it
    un-stripes."""
    return np.concatenate([np.arange(r, t, n) for r in range(n)])


def ring_attention(q, k, v, mesh: Optional[Mesh] = None,
                   causal: bool = False, axis_name: str = SEQ_AXIS,
                   block_impl: str = "auto", layout: str = "auto"):
    """Sequence-parallel attention over ``mesh``'s ``seq`` axis.

    ``q/k/v``: global ``[B, T, H, D]`` tensors, or
    :class:`~split_learning_tpu_torch.parallel.tensor.SeqBlocks` of a
    data row's T-partitioned blocks (the fused trainer's step), which
    the ring runs where they lie and returns as blocks. A tensor's T must
    divide by the seq axis size; it is scattered over the ranks and the
    output gathered back. With no mesh, or no ``seq`` axis, the
    single-device math runs (dense, or the flash kernels when
    ``block_impl`` resolves so).

    ``block_impl``: ``"dense"`` (each rank's O(T_local^2) scores in
    float32), ``"flash"`` (K5/K6 on every block) or ``"auto"``
    (:func:`_resolve_block_impl` on one rank's shapes). ``layout``:
    ``"contiguous"`` blocks, ``"striped"`` (token g on rank g % n, every
    causal hop about half masked) or ``"auto"``, which stripes exactly
    a causal flash ring; without ``causal`` a striped request runs
    contiguous. Striping blocks is a cross-rank exchange each way
    (:func:`~split_learning_tpu_torch.parallel.tensor.restripe`)."""
    _check_impl("ring", block_impl)
    if layout not in ("auto", "contiguous", "striped"):
        raise ValueError(f"Unknown ring layout: {layout!r} "
                         "(expected 'auto', 'contiguous' or 'striped')")
    blocks = isinstance(q, SeqBlocks)
    if not blocks and (mesh is None or axis_name not in mesh.axis_names):
        return _single_device(q, k, v, causal, block_impl)
    if blocks:
        b, t_local, h, _ = q.blocks[0].shape
        n, t, dev = q.n, q.t, q.devs[0]
    else:
        b, t, h, _ = q.shape
        n, dev = mesh.shape[axis_name], q.device
        b, t_local = _rows_batch(mesh, b), t // n
    # the dense body's residuals are float32 whatever the input dtype
    impl = _resolve_block_impl(block_impl, b, t_local, t, h, 4, dev)
    if layout == "auto":
        layout = "striped" if causal and impl == "flash" else "contiguous"
    if layout == "striped" and not causal:
        layout = "contiguous"
    body = _ring_flash if impl == "flash" else _ring_dense
    striped = layout == "striped"
    if blocks:
        if not striped:
            return _on_blocks(body, q, k, v, causal, striped=False)
        o = _on_blocks(body, *(restripe(x, True) for x in (q, k, v)),
                       causal, striped=True)
        return restripe(o, False)
    if striped:
        perm_np = stripe_permutation(t, n)
        perm = torch.as_tensor(perm_np, device=q.device)
        inv = torch.as_tensor(np.argsort(perm_np), device=q.device)
        o = _sharded(mesh, axis_name, body, q[:, perm], k[:, perm],
                     v[:, perm], causal, striped=True)
        return o[:, inv]
    return _sharded(mesh, axis_name, body, q, k, v, causal, striped=False)


def ulysses_attention(q, k, v, mesh: Optional[Mesh] = None,
                      causal: bool = False, axis_name: str = SEQ_AXIS,
                      block_impl: str = "auto"):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention; needs
    ``H`` divisible by the seq axis size. ``block_impl`` picks each
    rank's full-sequence math over its ``H / n`` heads (dense, flash, or
    ``"auto"``). ``q/k/v`` are tensors or
    :class:`~split_learning_tpu_torch.parallel.tensor.SeqBlocks`, as
    :func:`ring_attention` takes them. With no ``seq`` axis, the
    single-device math."""
    _check_impl("ulysses", block_impl)
    if isinstance(q, SeqBlocks):
        b, _, h, _ = q.blocks[0].shape
        impl = _resolve_block_impl(block_impl, b, q.t, q.t,
                                   max(h // q.n, 1),
                                   q.blocks[0].element_size(), q.devs[0])
        return _on_blocks(_ulysses, q, k, v, causal,
                          use_flash=impl == "flash")
    if mesh is None or axis_name not in mesh.axis_names:
        return _single_device(q, k, v, causal, block_impl)
    b, t, h, _ = q.shape
    n = mesh.shape[axis_name]
    impl = _resolve_block_impl(block_impl, _rows_batch(mesh, b), t, t,
                               max(h // n, 1), q.element_size(), q.device)
    return _sharded(mesh, axis_name, _ulysses, q, k, v, causal,
                    use_flash=impl == "flash")
