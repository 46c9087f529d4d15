"""The wire between the parties (counterpart of
``split_learning_tpu/transport``): the codec, the ``Transport`` contract
and the in-process ``LocalTransport``. HTTP waits for ROADMAP item 12."""

from split_learning_tpu_torch.transport.base import (
    Backpressure, FaultInjector, FaultyTransport, Transport, TransportError,
    TransportStats, backoff_delays)
from split_learning_tpu_torch.transport.local import LocalTransport

__all__ = ["Backpressure", "FaultInjector", "FaultyTransport",
           "LocalTransport", "Transport", "TransportError", "TransportStats",
           "backoff_delays"]
