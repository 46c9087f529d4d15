"""Observability of the two-party path: per-step spans, latency
histograms, instrumented locks (counterpart of ``split_learning_tpu/obs``).

Pure-Python copies of what the party runtime, the server, the replay
cache and the transports call::

    from split_learning_tpu_torch import obs
    tracer = obs.enable()            # zero overhead until this call
    ... run traced steps ...
    tracer.export_chrome("trace.json")
    obs.disable()

Beside them, as in JAX: the flight recorder (``obs/flight.py``), the
telemetry ring and SLO tracker (``obs/telemetry.py``) and the fleet
view (``obs/federate.py``), and the dispatch watchdog
(``obs/dispatch_debug.py``: kernel builds, per-scope launches and host
syncs inside step scopes, on with ``SLT_DISPATCH_DEBUG=1``), each off
until enabled.
"""

from split_learning_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, Histogram, Registry, render_prometheus)
from split_learning_tpu_torch.obs.trace import (  # noqa: F401
    CLIENT_PHASES, CTX, Tracer, disable, enable, enabled, get_tracer,
    maybe_enable_from_env)
