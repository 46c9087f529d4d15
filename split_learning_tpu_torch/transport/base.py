"""Transport: the swappable boundary between split-learning parties
(counterpart of ``split_learning_tpu/transport/base.py``).

The reference realises it as pickle-over-HTTP: ``POST /forward_pass``
carries activations and labels down and the cut-layer gradient back,
``GET /health`` reports mode and model (SURVEY.md §1 L2). The port has
:class:`~split_learning_tpu_torch.transport.local.LocalTransport`, the
in-process transport with full wire emulation; HTTP waits for ROADMAP
item 12.

Payloads at this boundary are numpy arrays, as in JAX, or tensors: a
transport hands the peer what it was given and returns the reply in the
caller's kind (a numpy caller gets numpy back, a tensor caller a tensor
on its own device), so a JAX party and a port party talk through the
same contract.
"""

from __future__ import annotations

import abc
import dataclasses
import random
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

Params = Any


class TransportError(RuntimeError):
    """A transport round-trip failed (network error, bad status, codec)."""


class Backpressure(TransportError):
    """The peer explicitly refused admission (tenant quota exhausted,
    queue full) and said when to come back — HTTP 429 + ``Retry-After``
    on the wire, this exception in-process. Subclasses TransportError so
    generic transient handling still applies, but callers that care
    (runtime/client.py, runtime/breaker.py) catch it first: an explicit
    429 is flow control, not a sick wire, so it must neither trip the
    circuit breaker nor be retried before ``retry_after_s`` elapses."""

    def __init__(self, message: str, retry_after_s: float = 0.0) -> None:
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


@dataclasses.dataclass
class TransportStats:
    """Per-op latency accounting — the reference has no timing at all
    (SURVEY.md §5 tracing); round-trip latency is the north-star metric,
    so every transport self-instruments."""

    round_trips: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    total_seconds: float = 0.0
    # free-form event counters (e.g. the server coalescer's
    # groups_flushed / requests_coalesced / flush_full / flush_window /
    # compile_count) — merged() sums them, summary() reports them
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    _latencies: list = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def record(self, seconds: float, sent: int = 0, received: int = 0) -> None:
        with self._lock:
            self.round_trips += 1
            self.bytes_sent += sent
            self.bytes_received += received
            self.total_seconds += seconds
            self._latencies.append(seconds)

    def add_bytes(self, sent: int = 0, received: int = 0) -> None:
        with self._lock:
            self.bytes_sent += sent
            self.bytes_received += received

    def incr(self, name: str, by: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def record_compression(self, raw_bytes: int, wire_bytes: int) -> None:
        """Account one compressed payload: logical fp32 bytes vs bytes
        actually shipped (q8/topk8 leaves only — see
        codec.compressed_leaf_bytes). summary() derives the cumulative
        ``compression_ratio`` from the two counters, and the server folds
        the same totals into the ``wire_compression_ratio`` gauge on
        /metrics."""
        with self._lock:
            self.counters["compress_raw_bytes"] = (
                self.counters.get("compress_raw_bytes", 0) + raw_bytes)
            self.counters["compress_wire_bytes"] = (
                self.counters.get("compress_wire_bytes", 0) + wire_bytes)

    def record_span(self, name: str, seconds: float) -> None:
        """Fold one obs span (obs/trace.py) into the counters dict as
        ``span_<name>_s`` / ``span_<name>_n`` — no schema change, so
        merged() pools per-phase totals across lanes and summary()
        reports them alongside the round-trip stats. Only called when
        tracing is enabled."""
        with self._lock:
            self.counters[f"span_{name}_s"] = (
                self.counters.get(f"span_{name}_s", 0.0) + seconds)
            self.counters[f"span_{name}_n"] = (
                self.counters.get(f"span_{name}_n", 0) + 1)

    def percentile(self, q: float) -> float:
        # snapshot under the lock, rank outside it: record() on the hot
        # path must never wait behind an O(n log n) percentile
        with self._lock:
            if not self._latencies:
                return float("nan")
            samples = list(self._latencies)
        return float(np.percentile(np.asarray(samples), q))

    @classmethod
    def merged(cls, stats_list: "list[TransportStats]") -> "TransportStats":
        """Pooled view over several transports (e.g. the pipelined
        client's lanes): counts sum, percentiles pool all samples."""
        m = cls()
        for s in stats_list:
            with s._lock:
                m.round_trips += s.round_trips
                m.bytes_sent += s.bytes_sent
                m.bytes_received += s.bytes_received
                m.total_seconds += s.total_seconds
                m._latencies.extend(s._latencies)
                for k, v in s.counters.items():
                    m.counters[k] = m.counters.get(k, 0) + v
        return m

    def summary(self) -> Dict[str, float]:
        out = {
            "round_trips": self.round_trips,
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "mean_ms": (self.total_seconds / self.round_trips * 1e3)
            if self.round_trips else float("nan"),
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
        }
        with self._lock:
            out.update(self.counters)
            wire = self.counters.get("compress_wire_bytes", 0)
            if wire > 0:
                out["compression_ratio"] = (
                    self.counters.get("compress_raw_bytes", 0) / wire)
        return out


class Transport(abc.ABC):
    """Client-side handle to the server party."""

    def __init__(self) -> None:
        self.stats = TransportStats()

    # -- classic 2-party split: one round trip per step ------------------
    @abc.abstractmethod
    def split_step(self, activations: np.ndarray, labels: np.ndarray,
                   step: int, client_id: int = 0) -> Tuple[np.ndarray, float]:
        """Send cut-layer activations + labels; receive (grad, loss).

        Contract of ``POST /forward_pass`` (``src/server_part.py:25-58``),
        with the loss returned explicitly instead of living only in MLflow.
        """

    # -- U-shaped split: two round trips per step ------------------------
    @abc.abstractmethod
    def u_forward(self, activations: np.ndarray, step: int,
                  client_id: int = 0) -> np.ndarray:
        """Hop 1: client acts -> server trunk features (labels stay home)."""

    @abc.abstractmethod
    def u_backward(self, feat_grads: np.ndarray, step: int,
                   client_id: int = 0) -> np.ndarray:
        """Hop 2: d(loss)/d(features) -> d(loss)/d(activations)."""

    # -- K-stage pipeline hops: per-microbatch exchanges with a stage
    # party, which the port does not have yet (ROADMAP item 16) -------
    def hop_forward(self, x: np.ndarray, step: int, mb: int = 0,
                    client_id: int = 0) -> np.ndarray:
        """One microbatch forward through the peer stage: acts in,
        next cut's acts out. Keyed (step, mb) for exactly-once."""
        raise NotImplementedError(
            f"{type(self).__name__} does not serve pipeline hops (the "
            "K-stage chain is ROADMAP item 16)")

    def hop_backward(self, g_out: np.ndarray, step: int, mb: int = 0,
                     client_id: int = 0) -> np.ndarray:
        """One microbatch cotangent through the peer stage (2BP reply:
        d(loss)/d(x) back immediately, weight update deferred)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not serve pipeline hops (the "
            "K-stage chain is ROADMAP item 16)")

    def hop_loss(self, x: np.ndarray, labels: np.ndarray, step: int,
                 mb: int = 0,
                 client_id: int = 0) -> Tuple[np.ndarray, float]:
        """The LAST stage's fused hop: acts + labels in, (scaled cut
        cotangent, microbatch loss) out."""
        raise NotImplementedError(
            f"{type(self).__name__} does not serve pipeline hops (the "
            "K-stage chain is ROADMAP item 16)")

    # -- split-party inference: one forward-only round trip --------------
    def predict(self, activations: np.ndarray,
                client_id: int = 0) -> np.ndarray:
        """Forward-only through the server party (no loss, no update, no
        step handshake): logits for the classic split, trunk features
        for the U-shape. Beyond the reference's training-only surface —
        transports without a serving peer may leave it unimplemented."""
        raise NotImplementedError(
            f"{type(self).__name__} does not serve split-party inference")

    # -- federated mode: one round trip per epoch ------------------------
    @abc.abstractmethod
    def aggregate(self, params: Params, epoch: int, loss: float,
                  step: int, num_examples: int | None = None) -> Params:
        """Submit local weights; receive the aggregated (FedAvg) weights.

        Contract of ``POST /aggregate_weights`` (``src/server_part.py:60-93``)
        — except aggregation here is a real mean, not the reference's
        single-client overwrite (``src/server_part.py:81-83``).
        ``num_examples`` is this client's epoch example count, the
        canonical FedAvg weight (None = uniform)."""

    @abc.abstractmethod
    def health(self) -> Dict[str, Any]:
        """Contract of ``GET /health`` (``src/server_part.py:95-102``)."""

    def close(self) -> None:
        pass


class FaultInjector:
    """Deterministic fault-injection hook (SURVEY.md §5 failure detection:
    'a fault-injection hook in the transport plugin').

    Raises TransportError on a seeded schedule so failure-handling policies
    (skip / retry / raise) are testable without a flaky network.
    """

    def __init__(self, failure_rate: float = 0.0, seed: int = 0,
                 fail_steps: Optional[set] = None) -> None:
        self._rng = np.random.RandomState(seed)
        self.failure_rate = failure_rate
        self.fail_steps = fail_steps or set()
        self.injected = 0

    def maybe_fail(self, op: str, step: int) -> None:
        if step in self.fail_steps or (
                self.failure_rate > 0 and self._rng.rand() < self.failure_rate):
            self.injected += 1
            raise TransportError(f"injected fault in {op!r} at step {step}")


class FaultyTransport(Transport):
    """Wraps any transport with a FaultInjector."""

    def __init__(self, inner: Transport, injector: FaultInjector) -> None:
        super().__init__()
        self.inner = inner
        self.injector = injector
        self.stats = inner.stats

    def split_step(self, activations, labels, step, client_id=0):
        self.injector.maybe_fail("split_step", step)
        return self.inner.split_step(activations, labels, step, client_id)

    def u_forward(self, activations, step, client_id=0):
        self.injector.maybe_fail("u_forward", step)
        return self.inner.u_forward(activations, step, client_id)

    def predict(self, activations, client_id=0):
        # -1: inference has no training step; a step-keyed injector
        # targeting real steps must not misfire on every predict
        self.injector.maybe_fail("predict", -1)
        return self.inner.predict(activations, client_id)

    def u_backward(self, feat_grads, step, client_id=0):
        self.injector.maybe_fail("u_backward", step)
        return self.inner.u_backward(feat_grads, step, client_id)

    def aggregate(self, params, epoch, loss, step, num_examples=None):
        self.injector.maybe_fail("aggregate", step)
        return self.inner.aggregate(params, epoch, loss, step,
                                    num_examples)

    def health(self):
        return self.inner.health()

    def close(self):
        self.inner.close()


def backoff_delays(initial: float = 0.5, factor: float = 2.0,
                   cap: float = 5.0, jitter: float = 0.0,
                   rng: Optional[Any] = None):
    """Exponential backoff schedule: ``initial * factor**i`` capped at
    ``cap``, each delay stretched by up to ``jitter`` of itself (uniform,
    from ``rng``). ``rng`` is any object with a zero-arg uniform draw —
    ``random.Random`` (``.random()``, what CircuitBreaker injects) or a
    ``np.random.RandomState`` (``.rand()``). Callers wanting N clients
    to spread out instead of thundering-herding a restarting server pass
    per-client seeds; determinism stays end to end (SLT004). Infinite
    generator; callers own the deadline."""
    if rng is None:
        rng = random.Random(0)
    draw = getattr(rng, "rand", None) or rng.random
    i = 0
    while True:
        d = min(initial * (factor ** i), cap)
        if jitter > 0:
            d *= 1.0 + jitter * float(draw())
        yield d
        i += 1


def timed(stats: TransportStats):
    """Context manager measuring one round trip."""
    class _Timer:
        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                stats.record(time.perf_counter() - self.t0)
            return False
    return _Timer()
