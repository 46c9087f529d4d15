"""Span-name registry: the one home of the trace taxonomy (counterpart of
``split_learning_tpu/obs/spans.py``, the names the two-party path
records). The tracer, the metrics histograms and any report agree on
these names; a call site names a span through this module, never as a
string literal. Stdlib-only.
"""

from __future__ import annotations

# -- client-party spans (obs/trace.py module docstring for semantics) -- #
CLIENT_FWD = "client_fwd"
TRANSPORT = "transport"
CLIENT_BWD = "client_bwd"
OPT_APPLY = "opt_apply"
STEP_TOTAL = "step_total"

# -- the HTTP client's split of its transport span: the codec both ways,
# and the round trip less the server's own spans ---------------------- #
ENCODE = "encode"
WIRE = "wire"

# -- server-party spans ------------------------------------------------ #
QUEUE_WAIT = "queue_wait"
DISPATCH = "dispatch"
D2H = "d2h"

# metrics-only counter: cumulative bytes a sharded party's sanctioned
# device-to-host gather moved (runtime/party.py ``_host_gather``)
GATHER_BYTES = "gather_bytes"

# metrics-histogram-only name (never a trace span: it would double-cover
# ``dispatch`` on a timeline); fed by the traced server and, under
# SLT_LOCK_DEBUG=1, by obs/locks.py InstrumentedLock
LOCK_HOLD = "lock_hold"

# -- admission control (runtime/admission.py): metrics-only counter and
# gauge names (never trace spans: admission happens before a request has
# a trace); render_prometheus adds the slt_ prefix ------------------- #
ADMISSION_ADMITTED = "admission_admitted"
ADMISSION_REJECTED = "admission_rejected"
ADMISSION_QUEUE_DEPTH = "admission_queue_depth"

# -- the decoupled backward (2BP, runtime/server.py) ------------------- #
# reply_grad: the client-visible reply window of a decoupled server, from
# the reply's launch (forward + the gradient of the activations only) to
# the reply in the caller's hands; recorded only with decouple_bwd on
REPLY_GRAD = "reply_grad"
# deferred_apply: one drained weight update (the gradient of the weights
# at the reply's parameters + the optimizer step), off the reply's path.
# Like lock_hold it never tiles a step next to ``dispatch``: a lag-0
# drain runs inside the same lock window
DEFERRED_APPLY = "deferred_apply"

# -- the K-stage chain (runtime/stage.py, runtime/pipeline_runner.py) -- #
# metrics-only counter: host copies on the hop path. A hop payload or
# reply that is a numpy array counts one on ``DeviceTransport``, which
# must read 0; ``HttpTransport`` counts 2 a hop (the request's encode
# and the reply's decode)
HOP_HOST_COPIES = "hop_host_copies"
# metrics-gauge-only name: the adaptive density controller's current
# density per wire, ``wire_density_<wire>``
WIRE_DENSITY = "wire_density"

# chrome-trace metadata event names (``ph: "M"``, not spans: no duration
# to tile a timeline with): the party's per-program MFU sidecar
# (``PartyRuntime.trace_metadata``) and the chain's per-stage sidecar
# (``PipelineRunner.trace_metadata``), JAX's names
MESH_META = "mesh_meta"
STAGE_META = "stage_meta"

# -- flight-recorder events (obs/flight.py) ---------------------------- #
# Causal runtime events, not spans: a point in a per-process sequence.
# JAX's names letter for letter, so ``scripts/postmortem.py`` merges a
# port dump with a JAX one. A call site names one through this module.
FL_ADMIT = "fl_admit"                    # admission granted (EDF deadline set)
FL_REJECT = "fl_reject"                  # Backpressure raised (quota/queue)
FL_CLAIM_BEGIN = "fl_claim_begin"        # replay claim decided (owner or not)
FL_CLAIM_RESOLVE = "fl_claim_resolve"    # owner published the reply
FL_CLAIM_FAIL = "fl_claim_fail"          # owner failed; claim removed
FL_CLAIM_WAIT = "fl_claim_wait"          # non-owner woke on a resolved claim
FL_REPLAY_HIT = "fl_replay_hit"          # wire-path duplicate served from cache
FL_GROUP_FORM = "fl_group_form"          # request enqueued at the coalescer
FL_GROUP_PICKUP = "fl_group_pickup"      # flusher collected a group
FL_DISPATCH = "fl_dispatch"              # server program launched
FL_REPLY = "fl_reply"                    # reply handed back to the caller
FL_DEFER_ENQ = "fl_defer_enqueue"        # deferred weight-apply queued (2BP)
FL_DEFER_APPLY = "fl_defer_apply"        # one deferred apply launched
FL_DEFER_FLUSH = "fl_defer_flush"        # deferred queue drained (lag/close)
FL_BREAKER = "fl_breaker"                # circuit breaker state transition
FL_CHAOS = "fl_chaos"                    # fault injected by the chaos wire
FL_CKPT_CAPTURE = "fl_ckpt_capture"      # runtime extras captured (lineage++)
FL_CKPT_COMMIT = "fl_ckpt_commit"        # extras durably committed (rename)
FL_CKPT_LINEAGE = "fl_ckpt_lineage"      # lineage adopted on restore/scan
FL_GATHER = "fl_gather"                  # sanctioned sharded host-gather
FL_SEND = "fl_send"                      # client posted a request
FL_RECV = "fl_recv"                      # party received a request/reply
FL_CLOSE = "fl_close"                    # runtime close entered
FL_WATCHDOG_TRIP = "fl_watchdog_trip"    # lock watchdog violation
FL_FATAL = "fl_fatal"                    # SIGTERM / fatal exception dump
# the K-stage chain's hops: every event carries ``stage``, ``mb`` and
# ``dir``/``op``, so a merged postmortem orders a microbatch's journey
FL_HOP_SEND = "fl_hop_send"              # pipeline hop posted toward a stage
FL_HOP_RECV = "fl_hop_recv"              # pipeline hop delivered/acknowledged
FL_STAGE_REPLY = "fl_stage_reply"        # stage replied (cut grad / acts)
# server replicas (runtime/replica.py)
FL_ROUTE = "fl_route"                    # client -> replica assignment made
FL_REPLICA_DEATH = "fl_replica_death"    # replica declared dead (breaker open)
FL_HANDOFF_BEGIN = "fl_handoff_begin"    # failover handoff started (quiesce)
FL_HANDOFF_COMMIT = "fl_handoff_commit"  # state merged; clients rerouted
# the telemetry plane: an SLO burn-rate alert transitioned (``tenant``,
# ``objective``, ``state``, both window burn rates)
FL_SLO_ALERT = "fl_slo_alert"            # SLO burn-rate alert fired/cleared
# elastic autoscaling (runtime/autoscale.py)
FL_SCALE_DECISION = "fl_scale_decision"  # autoscale policy verdict (non-hold)
FL_SCALE_UP = "fl_scale_up"              # replica spawned and adopted
FL_SCALE_DOWN = "fl_scale_down"          # replica retired via policy handoff

FLIGHT_EVENTS = (
    FL_ADMIT, FL_REJECT, FL_CLAIM_BEGIN, FL_CLAIM_RESOLVE, FL_CLAIM_FAIL,
    FL_CLAIM_WAIT, FL_REPLAY_HIT, FL_GROUP_FORM, FL_GROUP_PICKUP,
    FL_DISPATCH, FL_REPLY, FL_DEFER_ENQ, FL_DEFER_APPLY, FL_DEFER_FLUSH,
    FL_BREAKER, FL_CHAOS, FL_CKPT_CAPTURE, FL_CKPT_COMMIT,
    FL_CKPT_LINEAGE, FL_GATHER, FL_SEND, FL_RECV, FL_CLOSE,
    FL_WATCHDOG_TRIP, FL_FATAL, FL_HOP_SEND, FL_HOP_RECV,
    FL_STAGE_REPLY, FL_ROUTE, FL_REPLICA_DEATH, FL_HANDOFF_BEGIN,
    FL_HANDOFF_COMMIT, FL_SLO_ALERT, FL_SCALE_DECISION, FL_SCALE_UP,
    FL_SCALE_DOWN)

# -- the telemetry plane (obs/telemetry.py): metrics-gauge-only names,
# the per-tenant multi-window SLO burn rates (render_prometheus adds the
# slt_ prefix) ----------------------------------------------------- #
SLO_BURN_FAST = "slo_burn_rate_fast"
SLO_BURN_SLOW = "slo_burn_rate_slow"
# the replica router's live count and the autoscaler's last verdict
# (runtime/replica.py, runtime/autoscale.py)
REPLICAS_LIVE = "replicas_live"
AUTOSCALE_DECISION = "autoscale_decision"
# the replica router's histograms: a fenced client's wait for the
# handoff commit, and the handoff itself (quiesce to commit)
REPLICA_REROUTE_WAIT = "replica_reroute_wait"
REPLICA_HANDOFF_LATENCY = "replica_handoff_latency"

# the client-level phases that tile a step: the denominator of the
# compute-vs-wire fraction (queue_wait/dispatch belong to the server
# party; counting them would double-book)
CLIENT_PHASES = (CLIENT_FWD, TRANSPORT, CLIENT_BWD, OPT_APPLY)

# server-party span names, for reporting tools
SERVER_PHASES = (QUEUE_WAIT, DISPATCH, D2H)

# the spans of every two-party step, on any wire; an HTTP step adds
# ENCODE and WIRE
ALL_SPANS = (CLIENT_FWD, TRANSPORT, CLIENT_BWD, OPT_APPLY, STEP_TOTAL,
             QUEUE_WAIT, DISPATCH, D2H)

# what a decoupled server records besides
DECOUPLED_SPANS = (REPLY_GRAD, DEFERRED_APPLY)
