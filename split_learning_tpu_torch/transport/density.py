"""Adaptive topk8 density controller (``--compress-density auto``;
counterpart of ``split_learning_tpu/transport/density.py``, copied: the
JAX module is stdlib only, but its package's ``__init__`` imports jax).

Static density is a blunt instrument on a K-stage chain: the forward
hop of stage 1 and the backward hop of stage K−1 carry tensors with
very different sparsity tolerance, and the right setting drifts as
training descends. This controller picks a per-wire density from a
fixed geometric ladder, driven by exactly two observed signals — the
per-wire achieved compression ratio (the same raw/wire byte totals
behind the ``wire_compression_ratio`` gauge) and a rolling end-loss
parity budget in absolute nats.

Determinism is the design constraint, not an afterthought: the
controller is a pure function of the sequence of ``note_ratio`` /
``note_loss`` calls — no wall clock, no RNG, no float accumulation
order that depends on thread arrival (both notes fold under one lock
into per-window sums, and decisions happen only inside ``note_loss``,
which the runner calls single-threaded once per step). Same seed +
same schedule → bit-identical density trajectory, which the tests pin
against JAX's controller.

Decision rule, once per ``window`` losses:

- the first full window only establishes the loss baseline;
- if the window's mean loss drifted above the best prior window mean
  by more than ``budget_nats``, the compression is presumed to be
  eating signal: every wire loosens one rung (denser);
- otherwise the budget has slack: the wire with the *lowest* achieved
  ratio this window (the one paying the most bytes per logical byte)
  tightens one rung (sparser). Ties break on wire id, ascending.

The asymmetry (loosen all, tighten one) makes the controller fast to
back off and slow to squeeze — a loss regression is corrected within
one window, while byte savings accrue a rung at a time.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

# geometric ladder of candidate densities, densest first. AUTO_START
# indexes the default rung — the same 0.1 the static --compress-density
# default uses, so "auto" starts exactly where "0.1" stands still.
DENSITY_LADDER: Tuple[float, ...] = (0.4, 0.2, 0.1, 0.05, 0.025)
AUTO_START_RUNG = 2

DEFAULT_WINDOW = 8
DEFAULT_BUDGET_NATS = 0.05


class DensityController:
    """Per-wire adaptive density over a fixed ladder (module doc)."""

    def __init__(self, *, window: int = DEFAULT_WINDOW,
                 budget_nats: float = DEFAULT_BUDGET_NATS,
                 ladder: Tuple[float, ...] = DENSITY_LADDER,
                 start_rung: int = AUTO_START_RUNG) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
        if not ladder or any(d2 >= d1 for d1, d2
                             in zip(ladder, ladder[1:])):
            raise ValueError("ladder must be strictly decreasing")
        if not 0 <= start_rung < len(ladder):
            raise ValueError(f"start_rung {start_rung} outside ladder")
        self.window = int(window)
        self.budget_nats = float(budget_nats)
        self.ladder = tuple(float(d) for d in ladder)
        self.start_rung = int(start_rung)
        self._lock = threading.Lock()
        self._rung: Dict[str, int] = {}
        # per-wire (raw_bytes, wire_bytes) folded over the open window
        self._bytes: Dict[str, List[int]] = {}
        self._losses: List[float] = []
        self._best: Optional[float] = None
        self._windows = 0
        self._trajectory: List[Dict[str, Any]] = []

    # -- the transports' read side ------------------------------------- #
    def density(self, wire: str) -> float:
        """Current density for ``wire`` (registers it at the start rung
        on first sight, so a wire participates in decisions from its
        first request)."""
        with self._lock:
            rung = self._rung.setdefault(str(wire), self.start_rung)
            return self.ladder[rung]

    def note_ratio(self, wire: str, raw_bytes: int,
                   wire_bytes: int) -> None:
        """Fold one exchange's byte accounting into the open window —
        the same (logical, wire) pair the transports feed
        ``TransportStats.record_compression``."""
        with self._lock:
            self._rung.setdefault(str(wire), self.start_rung)
            tot = self._bytes.setdefault(str(wire), [0, 0])
            tot[0] += int(raw_bytes)
            tot[1] += int(wire_bytes)

    # -- the runner's write side (single-threaded, once per step) ------- #
    def note_loss(self, loss: float) -> None:
        """Fold one step's mean loss; closes (and decides) a window
        every ``window`` calls."""
        val = float(loss)  # host scalar before the lock
        with self._lock:
            self._losses.append(val)
            if len(self._losses) < self.window:
                return
            self._decide_locked()

    def _decide_locked(self) -> None:
        mean = sum(self._losses) / len(self._losses)
        self._losses = []
        window_bytes = self._bytes
        self._bytes = {}
        self._windows += 1
        rec: Dict[str, Any] = {"window": self._windows,
                               "mean_loss": mean}
        if self._best is None:
            self._best = mean
            rec.update(action="baseline", wire=None, drift=0.0)
        else:
            drift = mean - self._best
            rec["drift"] = drift
            if drift > self.budget_nats:
                # over budget: back off everywhere, one rung denser
                for w in self._rung:
                    self._rung[w] = max(0, self._rung[w] - 1)
                rec.update(action="loosen", wire=None)
            else:
                # under budget: squeeze the least-compressing wire.
                # Ratio per wire = raw/wire over this window; wires
                # with no traffic (or already at the sparsest rung)
                # are not candidates.
                cand = sorted(
                    (tot[0] / tot[1], w)
                    for w, tot in window_bytes.items()
                    if tot[1] > 0
                    and self._rung.get(w, self.start_rung)
                    < len(self.ladder) - 1)
                if cand:
                    _, w = cand[0]
                    self._rung[w] = self._rung[w] + 1
                    rec.update(action="tighten", wire=w)
                else:
                    rec.update(action="hold", wire=None)
            self._best = min(self._best, mean)
        rec["densities"] = {w: self.ladder[r]
                            for w, r in sorted(self._rung.items())}
        self._trajectory.append(rec)

    # -- observability -------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        """Full controller state for /metrics, the telemetry ring and
        ``trace_report`` — including the decision trajectory the
        determinism test pins."""
        with self._lock:
            return {
                "window": self.window,
                "budget_nats": self.budget_nats,
                "ladder": list(self.ladder),
                "windows_closed": self._windows,
                "densities": {w: self.ladder[r]
                              for w, r in sorted(self._rung.items())},
                "trajectory": [dict(rec) for rec in self._trajectory],
            }

    def densities(self) -> Dict[str, float]:
        with self._lock:
            return {w: self.ladder[r]
                    for w, r in sorted(self._rung.items())}
