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
# density per wire, ``wire_density_<wire>``, and the flight-recorder
# event names of a hop: JAX's, for the telemetry ring and the recorder
# (ROADMAP item 22)
WIRE_DENSITY = "wire_density"
FL_HOP_SEND = "fl_hop_send"
FL_HOP_RECV = "fl_hop_recv"
FL_STAGE_REPLY = "fl_stage_reply"

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
