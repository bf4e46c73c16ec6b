from .config import ServeConfig
from .errors import (
    ERROR_CODES,
    DeadlineExceededError,
    InvalidRequestError,
    QueueFullError,
    RequestError,
    ServeError,
    ServerClosedError,
    ServerDrainingError,
    SheddedError,
    WedgedStepError,
)
from .server import GraphServer, PredictionHandle
