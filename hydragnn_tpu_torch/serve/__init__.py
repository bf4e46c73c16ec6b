"""The serving plane: fault-tolerant micro-batched graph inference, hot
reload, reduced-precision weights and the replica fleet. Counterpart of
``hydragnn_tpu/serve``. ``api.run_server`` is the config-driven entry point,
``GraphServer`` the direct constructor; ``api.run_server_fleet`` starts the
multi-process fleet (``ReplicaManager`` supervising replica workers behind a
``FleetRouter`` with retries, hedging, circuit breakers and an optional
content-addressed ``PredictionCache``)."""

from .cache import PredictionCache, graph_key
from .config import QuantizationSpec, ServeConfig
from .errors import (
    ERROR_CODES,
    RETRYABLE_CODES,
    BreakerOpenError,
    DeadlineExceededError,
    InvalidRequestError,
    NoReplicasError,
    QueueFullError,
    ReplicaUnavailableError,
    RequestError,
    ServeError,
    ServerClosedError,
    ServerDrainingError,
    SheddedError,
    WedgedStepError,
    error_from_code,
)
from .reload import CheckpointWatcher
from .router import (
    CircuitBreaker,
    FleetRouter,
    HTTPReplicaClient,
    LocalReplicaClient,
    ReplicaClient,
)
from .server import GraphServer, PredictionHandle


def __getattr__(name):
    # the supervisor and the quantization plane load on first use
    if name == "ReplicaManager":
        from .fleet import ReplicaManager

        return ReplicaManager
    if name in ("QuantizationDriftError", "QuantizedInferenceState", "quantize_state",
                "quantize_weights"):
        from . import quantize

        return getattr(quantize, name)
    raise AttributeError(name)


__all__ = [
    "BreakerOpenError",
    "CheckpointWatcher",
    "CircuitBreaker",
    "DeadlineExceededError",
    "ERROR_CODES",
    "FleetRouter",
    "GraphServer",
    "HTTPReplicaClient",
    "InvalidRequestError",
    "LocalReplicaClient",
    "NoReplicasError",
    "PredictionCache",
    "PredictionHandle",
    "QuantizationDriftError",
    "QuantizationSpec",
    "QuantizedInferenceState",
    "QueueFullError",
    "ReplicaClient",
    "ReplicaManager",
    "ReplicaUnavailableError",
    "RequestError",
    "RETRYABLE_CODES",
    "ServeConfig",
    "ServeError",
    "ServerClosedError",
    "ServerDrainingError",
    "SheddedError",
    "WedgedStepError",
    "error_from_code",
    "graph_key",
    "quantize_state",
    "quantize_weights",
]
