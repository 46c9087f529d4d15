"""Multi-client split learning (counterpart of
``split_learning_tpu/runtime/multi_client.py``), BASELINE config 3.

The reference pins client replicas to 1 (``k8s/split-learning.yaml:49``)
and its server would race with more. Here N clients, each owning its own
bottom stage and data shard, interleave steps against one shared server
half, which applies each client's step under its lock with a per-client
handshake. Every ``sync_bottoms_every`` rounds the client bottoms are
FedAvg'd (:meth:`MultiClientSplitRunner.sync_bottoms`).

On the card each client's step is its ``SplitClientTrainer`` step (its
bottom's forward and backward, an SGD update of it is one K2 launch, its
wire encodes are K3 or the five topk8 select launches) and the server's
(K1 pair, K2). A compressed bottom sync encodes each ready client's
drift from the last agreed mean through the topk8 codec on the card:
five select launches per leaf and client, none on the first (dense)
sync.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import (
    Any, Callable, List, Optional, Sequence, Tuple, Union)

import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.runtime.client import SplitClientTrainer
from split_learning_tpu_torch.runtime.state import (
    adopt_params, compressed_sync_contribution, fedavg_mean)
from split_learning_tpu_torch.transport.base import Transport
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike

Init = Union[torch.Generator, Sequence[Params],
             Callable[[int], Union[torch.Generator, Sequence[Params]]]]


def _client_init(init: Init, i: int, n: int):
    """Client ``i``'s init: ``init(i)`` for a callable; for a generator,
    with more than one client, a generator seeded ``initial_seed + i``
    (the counterpart of JAX's ``fold_in(rng, i)``); else ``init``."""
    if callable(init) and not isinstance(init, torch.Generator):
        return init(i)
    if isinstance(init, torch.Generator) and n > 1:
        return torch.Generator().manual_seed(init.initial_seed() + i)
    return init


class MultiClientSplitRunner:
    """Drives N split clients round-robin (or, ``concurrent=True``, from
    a thread pool) against one server party.

    ``transport_factory(client_id)`` builds each client's transport.
    ``init`` is one init for every client (a ``torch.Generator`` or
    per-stage dicts), or a callable ``client_id -> init``.
    ``sync_bottoms_every > 0`` FedAvgs the bottoms every that many
    rounds. ``sync_compress`` (``"topk8"`` or ``"clapping"``) sends each
    later sync as topk8 deltas from the last agreed mean, with error
    feedback; the first sync is always dense. Bytes accumulate on
    ``sync_raw_bytes``/``sync_wire_bytes``. ``device`` defaults to
    ``"cuda"``. A ``profiler`` (``utils.profiling.PhaseProfiler``) is
    shared by every client, as in JAX (it is thread-safe)."""

    def __init__(self, plan: SplitPlan, cfg: Config, init: Init,
                 transport_factory: Callable[[int], Transport],
                 num_clients: Optional[int] = None,
                 sync_bottoms_every: int = 0,
                 logger: Optional[Any] = None,
                 concurrent: bool = False,
                 profiler: Optional[Any] = None,
                 sync_compress: Optional[str] = None,
                 sync_density: float = 0.1,
                 device: DeviceLike = "cuda") -> None:
        n = num_clients if num_clients is not None else cfg.num_clients
        if n < 1:
            raise ValueError("need at least one client")
        if sync_compress not in (None, "topk8", "clapping"):
            raise ValueError(
                f"unknown sync compression {sync_compress!r}")
        self.cfg = cfg
        self.sync_bottoms_every = sync_bottoms_every
        self.logger = logger
        self.concurrent = concurrent
        self._pool: Optional[ThreadPoolExecutor] = None
        self.clients: List[SplitClientTrainer] = [
            SplitClientTrainer(plan, cfg, _client_init(init, i, n),
                               transport_factory(i), profiler=profiler,
                               client_id=i, device=device)
            for i in range(n)]
        self._steps = [0] * n
        self._rounds = 0
        self.sync_compress = sync_compress
        self.sync_density = float(sync_density)
        self._sync_ef = None
        self._sync_ref = None  # the last agreed mean (the delta reference)
        self.sync_raw_bytes = 0
        self.sync_wire_bytes = 0
        if sync_compress is not None:
            from split_learning_tpu_torch.transport import codec
            self._sync_ef = codec.make_wire_ef(sync_compress)

    def train_round(self, batches_per_client: Sequence[Tuple[Any, Any]]
                    ) -> List[Optional[float]]:
        """One round: each client takes one step, in turn or all in
        flight at once. Every client's step lands before the round
        returns, so the per-client step counters stay sequential."""
        if len(batches_per_client) != len(self.clients):
            raise ValueError(
                f"expected {len(self.clients)} batches, "
                f"got {len(batches_per_client)}")

        def one(i: int, client: SplitClientTrainer, x: Any, y: Any
                ) -> Optional[float]:
            step = self._steps[i]
            loss = client.train_step(x, y, step)
            self._steps[i] += 1
            if loss is not None and self.logger is not None:
                self.logger.log_metric(f"loss_client{i}", loss, step=step)
            return loss

        pairs = list(zip(self.clients, batches_per_client))
        if self.concurrent and len(self.clients) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=len(self.clients),
                    thread_name_prefix="slt-client")
            futures = [self._pool.submit(one, i, c, x, y)
                       for i, (c, (x, y)) in enumerate(pairs)]
            losses = [f.result() for f in futures]
        else:
            losses = [one(i, c, x, y) for i, (c, (x, y)) in enumerate(pairs)]
        self._rounds += 1
        if (self.sync_bottoms_every
                and self._rounds % self.sync_bottoms_every == 0):
            self.sync_bottoms()
        return losses

    def train_rounds(self, batch_iters: Sequence[Any],
                     rounds: Optional[int] = None,
                     prefetch: int = 0) -> List[List[Optional[float]]]:
        """Whole rounds from per-client batch iterators: stops after
        ``rounds`` rounds or when any client's iterator drains (every
        round needs all clients). ``prefetch`` > 0 wraps each client's
        iterator in a :class:`~split_learning_tpu_torch.data.datasets.
        DevicePrefetch` of that depth on its client's device, so every
        client's next batch stages while the round is in flight; the
        wrappers are closed and joined on every exit path."""
        if len(batch_iters) != len(self.clients):
            raise ValueError(
                f"expected {len(self.clients)} batch iterators, "
                f"got {len(batch_iters)}")
        its: List[Any] = [iter(b) for b in batch_iters]
        wrapped: List[Any] = []
        if prefetch > 0:
            from split_learning_tpu_torch.data.datasets import DevicePrefetch
            its = wrapped = [DevicePrefetch(it, depth=prefetch,
                                            device=c.device)
                             for it, c in zip(its, self.clients)]
        losses: List[List[Optional[float]]] = []
        try:
            while rounds is None or len(losses) < rounds:
                batch = []
                for it in its:
                    try:
                        batch.append(next(it))
                    except StopIteration:
                        return losses
                losses.append(self.train_round(batch))
            return losses
        finally:
            for w in wrapped:
                w.close()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _flush_server_halves(self) -> None:
        """Flush each in-process server's deferred applies before a sync
        (``flush_deferred``: a decoupled server's state may be up to
        ``apply_lag`` updates behind the replies its clients hold),
        reached through the transports (unwrapping ``.inner``); each
        server once."""
        seen = set()
        for c in self.clients:
            t = getattr(c, "transport", None)
            while t is not None:
                srv = getattr(t, "server", None)
                if srv is not None:
                    flush = getattr(srv, "flush_deferred", None)
                    if callable(flush) and id(srv) not in seen:
                        seen.add(id(srv))
                        flush()
                    break
                t = getattr(t, "inner", None)

    def sync_bottoms(self) -> None:
        """FedAvg the bottoms of the clients that have trained (their
        optimizer state stays local). A client with no state, or whose
        step count never advanced, is neither averaged in nor
        overwritten. Each ready client adopts a copy of the mean, in the
        mean's dtypes (JAX's clients adopt the mean's tree)."""
        self._flush_server_halves()
        ready = [c for c in self.clients
                 if c.state is not None and int(c.state.step) > 0]
        if len(ready) < 2:
            return
        if self._sync_ef is not None and self._sync_ref is not None:
            # compressed round: each contribution is ref + topk8(drift);
            # error feedback repays each client's dropped drift next time
            contribs = []
            for c in ready:
                rec, raw_b, wire_b = compressed_sync_contribution(
                    self._sync_ef, f"sync_bottom{c.client_id}",
                    c.state.params, self._sync_ref, self.sync_density)
                self.sync_raw_bytes += raw_b
                self.sync_wire_bytes += wire_b
                contribs.append(rec)
            mean = fedavg_mean(contribs)
        else:
            # dense round: no reference yet (the first sync), or no
            # compression
            mean = fedavg_mean([c.state.params for c in ready])
        # the mean's tensors are new (two or more trees were averaged)
        if self._sync_ef is not None:
            self._sync_ref = mean
        for c in ready:
            adopt_params(c.state, mean, c.device)
