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

# -- server-party spans ------------------------------------------------ #
QUEUE_WAIT = "queue_wait"
DISPATCH = "dispatch"
D2H = "d2h"

# metrics-histogram-only name (never a trace span: it would double-cover
# ``dispatch`` on a timeline); fed by the traced server and, under
# SLT_LOCK_DEBUG=1, by obs/locks.py InstrumentedLock
LOCK_HOLD = "lock_hold"

# the client-level phases that tile a step: the denominator of the
# compute-vs-wire fraction (queue_wait/dispatch belong to the server
# party; counting them would double-book)
CLIENT_PHASES = (CLIENT_FWD, TRANSPORT, CLIENT_BWD, OPT_APPLY)

# server-party span names, for reporting tools
SERVER_PHASES = (QUEUE_WAIT, DISPATCH, D2H)

ALL_SPANS = (CLIENT_FWD, TRANSPORT, CLIENT_BWD, OPT_APPLY, STEP_TOTAL,
             QUEUE_WAIT, DISPATCH, D2H)
