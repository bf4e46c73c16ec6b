"""JSON wire codec for the serving fleet (replica /predict protocol).

Counterpart of ``hydragnn_tpu/serve/wire.py``: the same encodings, byte
for byte, so a replica of either package answers the other's router.

The router (serve/router.py) and replica workers (serve/replica.py) speak
plain JSON over HTTP — no new dependencies — but predictions must survive
the trip *bit-exactly* (the prediction cache asserts hit/miss identity, and
BENCH numbers comparing local vs fleet serving are only meaningful if the
wire is lossless). Arrays are therefore encoded as raw little-endian bytes
(base64) plus dtype and shape, never as JSON float literals: a float32
round-tripped through decimal text is not the same float32.

Failure payloads carry the stable ``code`` from serve/errors.py so the
client side reconstructs the *typed* exception — a router branching on
``RETRYABLE_CODES`` behaves identically against a remote replica and an
in-process server.

Wire format (version ``WIRE_V``):

- array:      ``{"__nd__": 1, "dtype": "<f4", "shape": [n, d], "b64": "..."}``
- ``None``:   JSON null; scalars/str/bool pass through natively
- graph:      ``{"v": 1, "fields": {name: array-or-null, ...},
                "dataset_id": int}``
- prediction: ``{"v": 1, "result": {head: array, ...}}``
- error:      ``{"v": 1, "error": {"code": "...", "message": "..."}}``
"""

from __future__ import annotations

import base64
import binascii
import json
from typing import Any, Dict, Optional

import numpy as np

from ..data.graph import Graph
from .errors import InvalidRequestError, ServeError, error_from_code

WIRE_V = 1

# Every array-bearing Graph field the codec ships (the non-array fields are
# dataset_id, handled explicitly, and the target dicts, which inference
# requests do not carry but the codec tolerates).
_GRAPH_ARRAY_FIELDS = (
    "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts",
    "pe", "rel_pe", "z", "graph_y", "cell",
)
_GRAPH_DICT_FIELDS = ("graph_targets", "node_targets")


def encode_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(np.asarray(a))
    return {
        "__nd__": 1,
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(obj: Dict[str, Any]) -> np.ndarray:
    try:
        dtype = np.dtype(obj["dtype"])
        shape = tuple(int(s) for s in obj["shape"])
        raw = base64.b64decode(obj["b64"].encode("ascii"))
    except (KeyError, TypeError, ValueError, binascii.Error) as e:
        raise InvalidRequestError(
            f"wire array field undecodable: {type(e).__name__}: {e}",
            reason="wire_truncated",
        )
    expected = dtype.itemsize * int(np.prod(shape, dtype=np.int64)) if shape \
        else dtype.itemsize
    if len(raw) != expected:
        raise InvalidRequestError(
            f"wire array payload is {len(raw)} bytes, expected {expected} "
            f"for dtype {dtype} shape {shape}",
            reason="wire_truncated",
        )
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _maybe_array(v: Any) -> Any:
    return None if v is None else encode_array(v)


def encode_graph(graph: Graph) -> Dict[str, Any]:
    fields: Dict[str, Any] = {
        name: _maybe_array(getattr(graph, name, None))
        for name in _GRAPH_ARRAY_FIELDS
    }
    for name in _GRAPH_DICT_FIELDS:
        table = getattr(graph, name, None)
        fields[name] = (
            None if table is None
            else {k: encode_array(v) for k, v in table.items()}
        )
    return {"v": WIRE_V, "fields": fields,
            "dataset_id": int(graph.dataset_id)}


def decode_graph(obj: Dict[str, Any]) -> Graph:
    try:
        fields = obj["fields"]
        kwargs: Dict[str, Any] = {}
        for name in _GRAPH_ARRAY_FIELDS:
            v = fields.get(name)
            kwargs[name] = None if v is None else decode_array(v)
        for name in _GRAPH_DICT_FIELDS:
            table = fields.get(name)
            kwargs[name] = (
                None if table is None
                else {k: decode_array(v) for k, v in table.items()}
            )
        kwargs["dataset_id"] = int(obj.get("dataset_id", 0))
    except InvalidRequestError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise InvalidRequestError(
            f"malformed wire graph: {e}", reason="wire_malformed"
        )
    for required in ("x", "pos", "senders", "receivers"):
        if kwargs.get(required) is None:
            raise InvalidRequestError(
                f"wire graph missing required field {required!r}",
                reason="wire_missing_field",
            )
    return Graph(**kwargs)


def encode_prediction(result: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {
        "v": WIRE_V,
        "result": {k: encode_array(v) for k, v in result.items()},
    }


def decode_prediction(obj: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: decode_array(v) for k, v in obj["result"].items()}


def encode_error(err: BaseException) -> Dict[str, Any]:
    code = getattr(err, "code", None) or ServeError.code
    return {"v": WIRE_V, "error": {"code": code, "message": str(err)}}


def decode_error(obj: Dict[str, Any]) -> ServeError:
    e = obj.get("error") or {}
    return error_from_code(str(e.get("code", ServeError.code)),
                           str(e.get("message", "")))


def dumps(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def loads(payload: bytes) -> Dict[str, Any]:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise InvalidRequestError(
            f"wire payload is not JSON: {e}", reason="wire_not_json"
        )
    if not isinstance(obj, dict):
        raise InvalidRequestError(
            "wire payload must be a JSON object", reason="wire_not_object"
        )
    return obj


def is_error(obj: Dict[str, Any]) -> bool:
    return isinstance(obj.get("error"), dict)


__all__ = [
    "WIRE_V",
    "decode_array", "decode_error", "decode_graph", "decode_prediction",
    "dumps", "encode_array", "encode_error", "encode_graph",
    "encode_prediction", "is_error", "loads",
]
