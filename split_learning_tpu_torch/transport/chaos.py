"""Deterministic fault injection: the chaos wire (counterpart of
``split_learning_tpu/transport/chaos.py``).

Every fault comes from a seeded schedule keyed by ``(path, step,
attempt)``, so a chaotic run is exactly reproducible: the same spec and
seed give the same faults at the same steps, and the same ones as the
JAX package's schedule. Two injection sites share one
:class:`ChaosPolicy`:

- :class:`ChaosTransport` wraps any client-side transport
  (``HttpTransport`` and ``LocalTransport`` alike);
- ``SplitHTTPServer(chaos=policy)`` injects on the server side of a real
  socket (5xx before apply, reply dropped or corrupted after apply,
  latency); see ``transport/http.py``.

Spec grammar (``--chaos`` on the CLI)::

    SPEC   := FAULT ("," FAULT)*
    FAULT  := KIND ["=" RATE] [":" MILLIS]      # MILLIS only for delay
    KIND   := drop_req | drop_resp | dup | delay | corrupt | http500

e.g. ``"drop_resp=0.1,dup=0.05,http500=0.05,delay=0.02:250"``. Rates
default to 0.05. At most one fault fires per attempt (one uniform draw
against the cumulative rates), and after ``max_faults_per_key`` faulted
attempts of the same (path, step) the schedule goes clean, so a bounded
retry policy always makes progress.

Fault semantics at the client wrapper:

==========  ==========================================================
drop_req    raise TransportError *before* the inner call.
drop_resp   run the inner call (the server applies), then raise: the
            reply was lost. Only the server's replay cache makes the
            retry safe (``runtime/replay.py``).
dup         run the inner call twice and return the second reply,
            which the replay cache must serve bit-equal.
delay       sleep the argument (ms, default 50), then proceed.
corrupt     raise before the inner call (the CRC check refuses a
            corrupted frame before the server applies anything).
http500     raise before the inner call (a 5xx before apply).
==========  ==========================================================

The K-stage chain's hop ops are keyed by the composite ``hop_seq(step,
mb)`` ordinal (the stages' replay key), so a fault of one microbatch's
hop never aliases another's draw. Each injection journals ``FL_CHAOS``
when the flight recorder is on.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.transport.base import Transport, TransportError

FAULT_KINDS = ("drop_req", "drop_resp", "dup", "delay", "corrupt",
               "http500")
DEFAULT_RATE = 0.05
DEFAULT_DELAY_MS = 50.0
# ops that carry a step handshake: chaos targets the step exchange;
# predict, aggregate and health pass through untouched. The hop ops are
# keyed by the composite (step, microbatch) ordinal.
CHAOS_OPS = ("/forward_pass", "/u_forward", "/u_backward",
             "/hop_forward", "/hop_backward", "/hop_loss")


def parse_chaos_spec(spec: str) -> "OrderedDict[str, Tuple[float, float]]":
    """Parse the spec grammar into ``{kind: (rate, arg)}`` preserving
    order (the cumulative draw walks kinds in spec order, so order is
    part of the schedule's identity)."""
    out: "OrderedDict[str, Tuple[float, float]]" = OrderedDict()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        arg = DEFAULT_DELAY_MS
        if ":" in part:
            part, arg_s = part.split(":", 1)
            try:
                arg = float(arg_s)
            except ValueError:
                raise ValueError(f"bad chaos arg {arg_s!r} in {spec!r}")
        rate = DEFAULT_RATE
        if "=" in part:
            part, rate_s = part.split("=", 1)
            try:
                rate = float(rate_s)
            except ValueError:
                raise ValueError(f"bad chaos rate {rate_s!r} in {spec!r}")
        kind = part.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown chaos kind {kind!r} (have {FAULT_KINDS})")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"chaos rate must be in [0, 1] (got {rate})")
        out[kind] = (rate, arg)
    if sum(r for r, _ in out.values()) > 1.0:
        raise ValueError(
            f"chaos rates sum to > 1 in {spec!r} (at most one fault "
            "fires per attempt: the rates share one uniform draw)")
    return out


class ChaosPolicy:
    """Seeded, stateless fault schedule: ``draw(path, step, attempt)``
    is a pure function of (seed, path, step, attempt), so client- and
    server-side injectors, a re-run, and JAX's schedule agree exactly."""

    def __init__(self, spec: str, seed: int = 0,
                 max_faults_per_key: int = 2) -> None:
        self.spec = spec
        self.seed = int(seed)
        self.faults = parse_chaos_spec(spec)
        # bounded chaos: after this many faulted attempts of one
        # (path, step) the schedule goes clean, so a retry policy with
        # max_retries >= max_faults_per_key always completes the step
        self.max_faults_per_key = int(max_faults_per_key)
        self.injected: Dict[str, int] = {}

    def draw(self, path: str, step: int,
             attempt: int = 0) -> Optional[Tuple[str, float]]:
        """The fault (kind, arg) for this delivery attempt, or None.
        Does not count the injection: callers that act on the fault call
        :meth:`count`."""
        if attempt >= self.max_faults_per_key:
            return None
        h = zlib.crc32(
            f"{self.seed}|{path}|{step}|{attempt}".encode("utf-8"))
        # RandomState does the bit mixing crc32 lacks; one draw per call
        u = float(np.random.RandomState(h & 0x7FFFFFFF).rand())
        acc = 0.0
        for kind, (rate, arg) in self.faults.items():
            acc += rate
            if u < acc:
                return kind, arg
        return None

    def count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1


class _AttemptCounter:
    """Bounded per-(path, step) delivery-attempt counter, so retries of
    the same step advance the schedule's ``attempt`` axis."""

    def __init__(self, cap: int = 4096) -> None:
        self._n: "OrderedDict[tuple, int]" = OrderedDict()
        self._cap = cap
        # a chain wire's forward and backward workers share one counter
        self._lock = threading.Lock()

    def next(self, key: tuple) -> int:
        with self._lock:
            n = self._n.get(key, 0)
            self._n[key] = n + 1
            while len(self._n) > self._cap:
                self._n.popitem(last=False)
            return n


class ChaosTransport(Transport):
    """Wraps any transport with the chaos schedule. Shares the inner
    transport's stats and counts every injection under
    ``stats.counters["chaos_<kind>"]``. The CLI builds it only when
    ``--chaos`` is given, so chaos-off is the untouched wire."""

    def __init__(self, inner: Transport, policy: ChaosPolicy) -> None:
        super().__init__()
        self.inner = inner
        self.policy = policy
        self.stats = inner.stats
        self._attempts = _AttemptCounter()

    def _do(self, path: str, step: int, call):
        attempt = self._attempts.next((path, step))
        fault = self.policy.draw(path, step, attempt)
        if fault is None:
            return call()
        kind, arg = fault
        self.policy.count(kind)
        self.stats.incr(f"chaos_{kind}")
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_CHAOS, step=int(step), party="client",
                      kind=kind, path=path, attempt=attempt)
        if kind == "delay":
            time.sleep(arg / 1e3)
            return call()
        if kind == "drop_resp":
            call()  # the server applied this; only the reply is lost
            raise TransportError(
                f"chaos: response for {path} step {step} dropped after "
                "server apply")
        if kind == "dup":
            call()  # first delivery applied; the duplicate follows
            return call()  # served from the replay cache
        # drop_req / corrupt / http500: the request never took effect
        raise TransportError(
            f"chaos: injected {kind} on {path} step {step}")

    def split_step(self, activations, labels, step, client_id=0):
        return self._do(
            "/forward_pass", step,
            lambda: self.inner.split_step(activations, labels, step,
                                          client_id))

    def u_forward(self, activations, step, client_id=0):
        return self._do(
            "/u_forward", step,
            lambda: self.inner.u_forward(activations, step, client_id))

    def u_backward(self, feat_grads, step, client_id=0):
        return self._do(
            "/u_backward", step,
            lambda: self.inner.u_backward(feat_grads, step, client_id))

    def hop_forward(self, x, step, mb=0, client_id=0):
        from split_learning_tpu_torch.runtime.stage import hop_seq
        return self._do(
            "/hop_forward", hop_seq(step, mb),
            lambda: self.inner.hop_forward(x, step, mb, client_id))

    def hop_backward(self, g_out, step, mb=0, client_id=0):
        from split_learning_tpu_torch.runtime.stage import hop_seq
        return self._do(
            "/hop_backward", hop_seq(step, mb),
            lambda: self.inner.hop_backward(g_out, step, mb, client_id))

    def hop_loss(self, x, labels, step, mb=0, client_id=0):
        from split_learning_tpu_torch.runtime.stage import hop_seq
        return self._do(
            "/hop_loss", hop_seq(step, mb),
            lambda: self.inner.hop_loss(x, labels, step, mb, client_id))

    def predict(self, activations, client_id=0):
        return self.inner.predict(activations, client_id)

    def aggregate(self, params, epoch, loss, step, num_examples=None):
        return self.inner.aggregate(params, epoch, loss, step,
                                    num_examples)

    def health(self) -> Dict[str, Any]:
        return self.inner.health()

    def wait_ready(self, *args, **kwargs):
        if hasattr(self.inner, "wait_ready"):
            return self.inner.wait_ready(*args, **kwargs)
        return self.inner.health()

    def close(self) -> None:
        self.inner.close()
