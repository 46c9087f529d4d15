"""The wire between the parties (counterpart of
``split_learning_tpu/transport``): the codec, the ``Transport`` contract,
the in-process ``LocalTransport``, the HTTP server and client, and the
seeded chaos wire."""

from split_learning_tpu_torch.transport.base import (
    Backpressure, FaultInjector, FaultyTransport, Transport, TransportError,
    TransportStats, backoff_delays)
from split_learning_tpu_torch.transport.chaos import (
    ChaosPolicy, ChaosTransport)
from split_learning_tpu_torch.transport.http import (
    HttpTransport, SplitHTTPServer)
from split_learning_tpu_torch.transport.local import LocalTransport

__all__ = ["Backpressure", "ChaosPolicy", "ChaosTransport", "FaultInjector",
           "FaultyTransport", "HttpTransport", "LocalTransport",
           "SplitHTTPServer", "Transport", "TransportError", "TransportStats",
           "backoff_delays"]
