"""Fleet view: cross-party metric federation and per-window
critical-path attribution (counterpart of
``split_learning_tpu/obs/federate.py``).

:class:`FleetCollector` scrapes every party's ``GET /telemetry`` (or an
in-process ring, or a recorded dump), merges the dumps into one view
keyed by ``(role, stage, replica)`` with the tenant dimension recovered
from the ``..._t<i>`` counter suffixes, and computes each window's
cross-party critical path: the hub's ``step_total`` seconds decomposed
into per-stage compute, queue wait, pure hop wire and bubble, and the
bottleneck party named.

Attribution (per window, summed seconds of histogram deltas):

- ``step_s``: the hub's ``step_total`` (the denominator);
- ``compute``: each stage's ``dispatch`` (+ ``reply_grad``);
- ``queue``: each stage's or server's ``queue_wait``;
- ``wire``: the hub's per-hop ``WIRE`` sum brackets the remote work, so
  pure wire is that sum less every stage's compute and queue, clamped
  at 0;
- ``bubble``: what ``step_s`` leaves after compute, queue and wire,
  clamped at 0 (fill/drain stalls and hub-side work). Shares are over
  the components, not over ``step_s``.

Windows align by ring index (every ring advances on the same interval).
:func:`serve_telemetry` gives a party that is not a ``SplitHTTPServer``
(the chain's hub) a ``/telemetry`` endpoint of its own. Stdlib-only.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from split_learning_tpu_torch.obs import spans

DEFAULT_SCRAPE_TIMEOUT_S = 5.0

# the per-tenant counter suffix runtime/admission.py emits
_TENANT_RE = re.compile(r"^(?P<base>.+)_t(?P<tenant>\d+)$")

# the stage-side compute histograms (dispatch is the jitted program
# window; reply_grad is the decoupled-backward reply window)
_COMPUTE_HISTS = (spans.DISPATCH, spans.REPLY_GRAD)


def split_tenant(name: str) -> Tuple[str, Optional[int]]:
    """``admission_admitted_t2`` -> (``admission_admitted``, 2);
    un-suffixed names -> (name, None)."""
    m = _TENANT_RE.match(name)
    if m is None:
        return name, None
    return m.group("base"), int(m.group("tenant"))


def party_key(role: str, stage: Optional[int] = None,
              replica: Optional[int] = None) -> str:
    """The canonical fleet-view key: ``role[stage][replica]`` with the
    absent dimensions elided (``hub``, ``stage1``, ``server.r0``)."""
    key = str(role)
    if stage is not None:
        key += str(int(stage))
    if replica is not None:
        key += f".r{int(replica)}"
    return key


def _hist_sum(window: Dict[str, Any], *names: str) -> float:
    total = 0.0
    hists = window.get("histograms", {}) or {}
    for name in names:
        h = hists.get(name)
        if h:
            total += float(h.get("sum", 0.0))
    return total


def _hist_count(window: Dict[str, Any], name: str) -> int:
    h = (window.get("histograms", {}) or {}).get(name)
    return int(h.get("count", 0)) if h else 0


class FleetCollector:
    """Scrapes N parties and folds their telemetry dumps into one view.

    ``parties`` is a list of dicts, each naming its coordinates and ONE
    source::

        {"role": "stage", "stage": 1, "url": "http://h:8471"}
        {"role": "hub", "ring": <TelemetryRing>}          # in-process
        {"role": "server", "replica": 0, "dump": {...}}   # recorded
        {"role": "server", "fetch": callable -> dump}

    URLs may point at the party base (``/telemetry`` is appended) or at
    the endpoint itself. A party that fails to scrape stays in the view
    with ``error`` set — a dead replica is a finding, not a crash.
    """

    def __init__(self, parties: List[Dict[str, Any]],
                 timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S) -> None:
        self.parties = list(parties)
        self.timeout_s = float(timeout_s)

    # -------------------------------------------------------------- #
    def _fetch_one(self, party: Dict[str, Any]) -> Dict[str, Any]:
        role = party.get("role", "server")
        out: Dict[str, Any] = {
            "role": role,
            "stage": party.get("stage"),
            "replica": party.get("replica"),
            "key": party_key(role, party.get("stage"),
                             party.get("replica")),
            "telemetry": None, "error": None,
        }
        try:
            if "dump" in party:
                out["telemetry"] = party["dump"]
            elif "ring" in party:
                ring = party["ring"]
                ring.advance(force=False)
                out["telemetry"] = ring.dump()
            elif "fetch" in party:
                out["telemetry"] = party["fetch"]()
            elif "url" in party:
                url = party["url"].rstrip("/")
                if not url.endswith("/telemetry"):
                    url += "/telemetry"
                with urllib.request.urlopen(
                        url, timeout=self.timeout_s) as resp:
                    out["telemetry"] = json.loads(resp.read())
            else:
                out["error"] = "party has no url/ring/fetch/dump source"
        except Exception as exc:  # noqa: BLE001 — a dead party is data
            out["error"] = f"{type(exc).__name__}: {exc}"
        return out

    # -------------------------------------------------------------- #
    def collect(self) -> Dict[str, Any]:
        """One federation pass: scrape everything, merge, attribute."""
        scraped = [self._fetch_one(p) for p in self.parties]
        merged = merge_fleet(scraped)
        attribution = critical_path(scraped)
        merged["critical_path"] = attribution
        merged["bottlenecks"] = bottleneck_histogram(attribution)
        return merged


def merge_fleet(scraped: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The fleet view: per-party latest-window summaries keyed by
    ``party_key``, fleet-total rates (counters summed across parties,
    per-tenant splits recovered from the ``_t<i>`` suffix), the union
    of SLO burn gauges, and every party's firing alerts."""
    parties: Dict[str, Any] = {}
    fleet_rates: Dict[str, float] = {}
    tenant_rates: Dict[str, Dict[str, float]] = {}
    burn: Dict[str, float] = {}
    firing: List[Dict[str, Any]] = []
    for s in scraped:
        dump = s.get("telemetry") or {}
        windows = dump.get("windows") or []
        last = windows[-1] if windows else {}
        parties[s["key"]] = {
            "role": s["role"], "stage": s["stage"],
            "replica": s["replica"], "error": s["error"],
            "windows": len(windows),
            "rates": dict(last.get("rates", {}) or {}),
            "gauges": dict(last.get("gauges", {}) or {}),
            "percentiles": dict(last.get("percentiles", {}) or {}),
        }
        for name, rate in (last.get("rates", {}) or {}).items():
            base, tenant = split_tenant(name)
            fleet_rates[name] = fleet_rates.get(name, 0.0) + float(rate)
            if tenant is not None:
                per = tenant_rates.setdefault(f"t{tenant}", {})
                per[base] = per.get(base, 0.0) + float(rate)
        slo = dump.get("slo") or {}
        for name, v in (slo.get("burn") or {}).items():
            burn[f"{s['key']}:{name}"] = float(v)
        for f in (slo.get("firing") or []):
            firing.append({"party": s["key"], **f})
    return {
        "version": 1,
        "kind": "slt-fleet",
        "parties": parties,
        "fleet_rates": fleet_rates,
        "tenant_rates": tenant_rates,
        "slo_burn": burn,
        "slo_firing": firing,
    }


def _windows_by_index(dump: Optional[Dict[str, Any]]
                      ) -> Dict[int, Dict[str, Any]]:
    if not dump:
        return {}
    return {int(w.get("index", i)): w
            for i, w in enumerate(dump.get("windows") or [])}


def critical_path(scraped: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-window decomposition of the hub's step_total into stage
    compute / queue-wait / pure hop wire / bubble (module docstring for
    the model), naming the bottleneck party per window. Empty when no
    hub party (or no hub windows with steps) is present."""
    hub = next((s for s in scraped if s["role"] == "hub"
                and s.get("telemetry")), None)
    if hub is None:
        return []
    stages = sorted(
        (s for s in scraped
         if s["role"] in ("stage", "server") and s.get("telemetry")),
        key=lambda s: (s.get("stage") or 0, s.get("replica") or 0))
    hub_windows = _windows_by_index(hub["telemetry"])
    stage_windows = [(s, _windows_by_index(s["telemetry"]))
                     for s in stages]
    out: List[Dict[str, Any]] = []
    for idx in sorted(hub_windows):
        hw = hub_windows[idx]
        steps = _hist_count(hw, spans.STEP_TOTAL)
        step_s = _hist_sum(hw, spans.STEP_TOTAL)
        if steps <= 0 or step_s <= 0.0:
            continue  # idle window: nothing to attribute
        hop_round_s = _hist_sum(hw, spans.WIRE)
        compute_s: Dict[str, float] = {}
        queue_s: Dict[str, float] = {}
        for s, windows in stage_windows:
            w = windows.get(idx)
            if w is None:
                continue
            compute_s[s["key"]] = _hist_sum(w, *_COMPUTE_HISTS)
            queue_s[s["key"]] = _hist_sum(w, spans.QUEUE_WAIT)
        remote_s = sum(compute_s.values()) + sum(queue_s.values())
        wire_s = max(hop_round_s - remote_s, 0.0)
        bubble_s = max(
            step_s - sum(compute_s.values()) - sum(queue_s.values())
            - wire_s, 0.0)
        components = (
            [(key, "compute", v) for key, v in compute_s.items()]
            + [(key, "queue", v) for key, v in queue_s.items()]
            + [(hub["key"], "wire", wire_s),
               (hub["key"], "bubble", bubble_s)])
        total = sum(v for _, _, v in components)
        party, kind, worst = max(components, key=lambda c: c[2])
        out.append({
            "index": idx,
            "steps": steps,
            "step_s": step_s,
            "compute_s": compute_s,
            "queue_s": queue_s,
            "wire_s": wire_s,
            "bubble_s": bubble_s,
            "bottleneck": {
                "party": party, "kind": kind, "seconds": worst,
                "share": (worst / total) if total > 0 else 0.0,
            },
        })
    return out


def bottleneck_histogram(attribution: List[Dict[str, Any]]
                         ) -> Dict[str, int]:
    """How many windows each party was the bottleneck of (the fleet
    view's headline)."""
    out: Dict[str, int] = {}
    for w in attribution:
        key = w["bottleneck"]["party"]
        out[key] = out.get(key, 0) + 1
    return out


# ---------------------------------------------------------------------- #
def serve_telemetry(ring: Any, host: str = "127.0.0.1", port: int = 0
                    ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Minimal ``/telemetry`` endpoint for parties that are not a
    SplitHTTPServer (the hub trainer): GET /telemetry advances the ring
    and serves its dump. Returns (server, thread); call
    ``server.shutdown()`` to stop. Serialization happens here, outside
    any runtime lock: the ring's dump is a plain dict."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path.split("?")[0] != "/telemetry":
                self.send_error(404)
                return
            ring.advance()
            body = json.dumps(ring.dump()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a: Any) -> None:  # quiet
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.daemon_threads = True
    thread = threading.Thread(
        target=srv.serve_forever, name="slt-hub-telemetry", daemon=True)
    thread.start()
    return srv, thread
