"""The wire between the parties (counterpart of
``split_learning_tpu/transport``): the codec, the ``Transport`` contract,
the in-process ``LocalTransport``, the HTTP server and client, the
seeded chaos wire, the K-stage chain's device-native ``DeviceTransport``
and the adaptive density controller."""

from split_learning_tpu_torch.transport.base import (
    Backpressure, FaultInjector, FaultyTransport, Transport, TransportError,
    TransportStats, backoff_delays)
from split_learning_tpu_torch.transport.chaos import (
    ChaosPolicy, ChaosTransport)
from split_learning_tpu_torch.transport.density import DensityController
from split_learning_tpu_torch.transport.device import DeviceTransport
from split_learning_tpu_torch.transport.http import (
    HttpTransport, SplitHTTPServer)
from split_learning_tpu_torch.transport.local import LocalTransport

__all__ = ["Backpressure", "ChaosPolicy", "ChaosTransport",
           "DensityController", "DeviceTransport", "FaultInjector",
           "FaultyTransport", "HttpTransport", "LocalTransport",
           "SplitHTTPServer", "Transport", "TransportError", "TransportStats",
           "backoff_delays"]
