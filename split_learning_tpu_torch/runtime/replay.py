"""Bounded replay cache: exactly-once step delivery within a window
(counterpart of ``split_learning_tpu/runtime/replay.py``).

The strict-step handshake (``ServerRuntime._check_step``) makes delivery
*at-most-once*: a retried request whose original was applied gets a 409,
the lost-response desync. So the server remembers the reply: each
applied ``(client_id, op, step)`` keeps its result in a bounded FIFO
window, and a duplicate delivery inside the window is served the
*original* reply (not recomputed: the retry's payload may differ under
EF compression, and recomputing would apply the update twice). Below
the window the 409 remains.

Entries are futures: :meth:`ReplayCache.begin` claims a (client, op,
step) exactly once and leaves a pending entry behind; duplicates that
lose the claim block on it (:meth:`ReplayCache.wait`) and are served
the one materialised result. Entries can also carry the exact encoded
wire reply (:meth:`ReplayCache.attach_body`), so a replayed frame is
byte-identical. :meth:`ReplayCache.export_state` and
:meth:`ReplayCache.restore_state` carry the resolved entries, bodies
included, through the checkpoint's runtime-extras sidecar
(``runtime/checkpoint.py``), so a duplicate that reaches a restarted
server is served the pre-crash frame byte for byte.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans

Key = Tuple[int, str, int]  # (client_id, op, step)


class _Entry:
    """One (client, op, step) reply slot — pending until resolved.

    ``event`` fires once the owner either resolved (``done``, result and
    maybe the encoded body are readable) or failed (``error`` set, the
    entry already removed from the cache so a later retry can re-own the
    step). Waiters hold a direct reference, so eviction can never strand
    them."""

    __slots__ = ("key", "event", "done", "result", "body", "error")

    def __init__(self, key: Key) -> None:
        self.key = key
        self.event = obs_locks.make_event("ReplayCache._Entry.event")
        self.done = False
        self.result: Any = None
        self.body: Optional[bytes] = None
        self.error: Optional[BaseException] = None


class ReplayCache:
    """FIFO reply cache, bounded per-(client, op) and globally.

    ``window`` bounds each (client_id, op) stream: a client retrying its
    last few steps always hits; anything older ages out. ``max_total``
    bounds the whole cache so a burst of client ids cannot grow it
    without limit (same discipline as the u_residual store). Only
    resolved entries are evictable — a pending entry has an owner thread
    mid-materialization and waiters parked on it.
    """

    def __init__(self, window: int = 8, max_total: int = 64) -> None:
        self.window = int(window)
        self.max_total = int(max_total)
        self._entries: "OrderedDict[Key, _Entry]" = OrderedDict()
        self._lock = obs_locks.make_lock("ReplayCache._lock",
                                         reentrant=False)
        self.hits = 0
        self.body_hits = 0
        self.evictions = 0

    # -- ownership: the in-flight-future protocol ---------------------- #
    def begin(self, client_id: int, op: str,
              step: int) -> Tuple[_Entry, bool]:
        """Claim (client_id, op, step). Returns ``(entry, owner)``:
        exactly one caller per key gets ``owner=True`` and must later
        :meth:`resolve` or :meth:`fail` the entry; everyone else gets
        the existing entry (pending or resolved) to :meth:`wait` on."""
        key = (int(client_id), op, int(step))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = _Entry(key)
                self._entries[key] = entry
                self._evict_locked(int(client_id), op)
                owner = True
            else:
                owner = False
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_CLAIM_BEGIN, step=int(step),
                      client_id=int(client_id), party="server",
                      op=op, owner=owner)
        return entry, owner

    def resolve(self, entry: _Entry, result: Any) -> None:
        """Publish the owner's materialized result and wake waiters.
        Idempotent; never overwrites (first apply wins)."""
        with self._lock:
            if entry.done:
                return
            entry.result = result
            entry.done = True
        entry.event.set()
        fl = obs_flight.get_recorder()
        if fl is not None:
            cid, op, step = entry.key
            fl.record(spans.FL_CLAIM_RESOLVE, step=step, client_id=cid,
                      party="server", op=op)

    def fail(self, entry: _Entry, error: BaseException) -> None:
        """Owner's apply never produced a result (admission 409, dispatch
        error): remove the claim so a later retry can re-own the step,
        store the error for anyone already waiting, wake them."""
        with self._lock:
            if entry.done:
                return
            entry.error = error
            if self._entries.get(entry.key) is entry:
                del self._entries[entry.key]
        entry.event.set()
        fl = obs_flight.get_recorder()
        if fl is not None:
            cid, op, step = entry.key
            fl.record(spans.FL_CLAIM_FAIL, step=step, client_id=cid,
                      party="server", op=op, error=type(error).__name__)

    def wait(self, entry: _Entry, timeout: float = 120.0) -> Any:
        """Block a duplicate on the in-flight future; counts the hit.
        Re-raises the owner's error if the original apply failed (the
        duplicate of a 409'd step is itself that same 409)."""
        if not entry.event.wait(timeout=timeout):
            raise TimeoutError(
                f"replayed step {entry.key} still in flight after "
                f"{timeout}s")
        if entry.error is not None:
            raise entry.error
        with self._lock:
            self.hits += 1
            result = entry.result
        fl = obs_flight.get_recorder()
        if fl is not None:
            cid, op, step = entry.key
            fl.record(spans.FL_CLAIM_WAIT, step=step, client_id=cid,
                      party="server", op=op)
        return result

    # -- value-level surface ------------------------------------------- #
    def get(self, client_id: int, op: str, step: int) -> Optional[Any]:
        """The cached result for a duplicate delivery, or None on a miss.
        Counts the hit. Non-blocking: a still-pending entry reads as a
        miss (callers that can block use :meth:`begin`/:meth:`wait` or
        :meth:`lookup`)."""
        key = (int(client_id), op, int(step))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or not entry.done:
                return None
            self.hits += 1
            return entry.result

    def contains(self, client_id: int, op: str, step: int) -> bool:
        with self._lock:
            return (int(client_id), op, int(step)) in self._entries

    def put(self, client_id: int, op: str, step: int, result: Any) -> None:
        key = (int(client_id), op, int(step))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                if entry.done:
                    return  # first apply wins; never overwrite a reply
            else:
                entry = _Entry(key)
                self._entries[key] = entry
            entry.result = result
            entry.done = True
            self._evict_locked(int(client_id), op)
        entry.event.set()

    # ------------------------------------------------------------------ #
    def attach_body(self, client_id: int, op: str, step: int,
                    body: bytes) -> None:
        """Attach the encoded wire reply to an existing entry so replays
        are served byte-identical. No-op on a missing entry (evicted
        since) or if a body is already attached."""
        key = (int(client_id), op, int(step))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.body is None:
                entry.body = body

    def get_body(self, client_id: int, op: str, step: int
                 ) -> Optional[bytes]:
        """The original encoded reply bytes, or None. Counts a body hit
        (the caller serves these raw: the bit-identical path)."""
        key = (int(client_id), op, int(step))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.body is None:
                return None
            self.body_hits += 1
            return entry.body

    def lookup(self, client_id: int, op: str, step: int,
               timeout: float = 120.0
               ) -> Tuple[Optional[bytes], Optional[Any]]:
        """Wire-server duplicate check: ``(body, result)``. Blocks on a
        pending entry — a duplicate that arrives while the original is
        still materializing waits for the one D2H instead of 409-ing.
        Prefers the attached body (bit-identical replay); falls back to
        the in-process result; ``(None, None)`` on a miss or when the
        original's apply failed (the retry then re-runs the op and gets
        the failure first-hand)."""
        key = (int(client_id), op, int(step))
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            return None, None
        if not entry.event.wait(timeout=timeout) or entry.error is not None:
            return None, None
        with self._lock:
            if entry.body is not None:
                self.body_hits += 1
                body, result = entry.body, None
            else:
                self.hits += 1
                body, result = None, entry.result
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_REPLAY_HIT, step=int(step),
                      client_id=int(client_id), party="server", op=op,
                      body=body is not None)
        return body, result

    # ------------------------------------------------------------------ #
    def _evict_locked(self, client_id: int, op: str) -> None:
        mine = [k for k, e in self._entries.items()
                if k[0] == client_id and k[1] == op and e.done]
        pending = sum(1 for k, e in self._entries.items()
                      if k[0] == client_id and k[1] == op and not e.done)
        while len(mine) + pending > self.window and mine:
            victim = mine.pop(0)  # FIFO: entries insert in step order
            del self._entries[victim]
            self.evictions += 1
        while len(self._entries) > self.max_total:
            for key, entry in self._entries.items():
                if entry.done:
                    del self._entries[key]
                    self.evictions += 1
                    break
            else:
                break  # everything left is pending; let owners finish
        return

    def clear(self) -> None:
        """Drop everything: a resume re-bases the step floor, and replies
        of the pre-restore lineage must not be replayable."""
        with self._lock:
            self._entries.clear()

    # -- persistence (the checkpoint's runtime-extras sidecar) ---------- #
    def export_state(self) -> list:
        """Resolved entries only, in FIFO order. A pending entry has an
        owner thread mid-materialization: its result does not exist yet,
        so it cannot be made durable; after a crash the retry re-owns
        the step. Bodies ride along, so a post-restart duplicate is
        served the byte-identical wire reply."""
        with self._lock:
            return [{"key": list(e.key), "result": e.result, "body": e.body}
                    for e in self._entries.values() if e.done]

    def restore_state(self, entries: list) -> None:
        """Repopulate from :meth:`export_state` output. Every restored
        entry is born resolved (event already set), so pre-crash
        duplicates are served at once, never blocked on an owner that no
        longer exists."""
        with self._lock:
            self._entries.clear()
            for rec in entries:
                cid, op, step = rec["key"]
                key = (int(cid), str(op), int(step))
                entry = _Entry(key)
                entry.result = rec.get("result")
                body = rec.get("body")
                entry.body = bytes(body) if body is not None else None
                entry.done = True
                entry.event.set()
                self._entries[key] = entry

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {
                "replay_hits": self.hits,
                "replay_body_hits": self.body_hits,
                "replay_evictions": self.evictions,
                "replay_cache_size": len(self._entries),
            }
