"""Observability of the two-party path: per-step spans, latency
histograms, instrumented locks (counterpart of ``split_learning_tpu/obs``).

Pure-Python copies of what the party runtime, the server, the replay
cache and the transports call::

    from split_learning_tpu_torch import obs
    tracer = obs.enable()            # zero overhead until this call
    ... run traced steps ...
    tracer.export_chrome("trace.json")
    obs.disable()

The flight recorder, the dispatch watchdog, the telemetry plane and the
Prometheus text exposition are not ported (ROADMAP items 22-23).
"""

from split_learning_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, Histogram, Registry)
from split_learning_tpu_torch.obs.trace import (  # noqa: F401
    CLIENT_PHASES, CTX, Tracer, disable, enable, enabled, get_tracer)
