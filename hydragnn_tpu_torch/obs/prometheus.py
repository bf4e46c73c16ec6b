"""Prometheus text exposition + the scrape/health HTTP endpoint.

``render_text`` serializes a ``MetricsRegistry`` in the Prometheus text
exposition format (version 0.0.4: ``# HELP``/``# TYPE`` headers, one
``name{labels} value`` line per sample, histogram ``_bucket``/``_sum``/
``_count`` series). ``TelemetryHTTPServer`` is the stdlib HTTP surface both
planes mount it on:

- ``/metrics``  — the scrape endpoint (text/plain; version=0.0.4)
- ``/healthz``  — liveness: 200 while the owning process is serving its
  purpose, 503 with a JSON detail once it has failed
- ``/readyz``   — readiness: 200 only once the owner's warm-up contract
  holds (for ``GraphServer`` that is the full-ladder warm-up flip — the
  same event that opens the serve loop; for training it is simply "loop
  running"). Load balancers route on this, so it must never report ready
  before the zero-retrace steady state is established.

Mandatory on ``GraphServer`` (``Serving.http_port``, default 0 = ephemeral
loopback port), opt-in for training (``Telemetry.http_port``). Binding is
best-effort at the call sites: an occupied port degrades to a warning —
losing the scrape surface must never take down training or serving.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from .registry import MetricsRegistry, registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def render_text(reg: Optional[MetricsRegistry] = None) -> str:
    """The registry in Prometheus text exposition format 0.0.4."""
    reg = reg if reg is not None else registry()
    lines = []
    for metric in reg.collect():
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for suffix, labels, value in metric.samples():
            if labels:
                lab = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in labels
                )
                lines.append(
                    f"{metric.name}{suffix}{{{lab}}} {_format_value(value)}"
                )
            else:
                lines.append(f"{metric.name}{suffix} {_format_value(value)}")
    return "\n".join(lines) + "\n"


class TelemetryHTTPServer:
    """Daemon-threaded scrape/health endpoint over a registry.

    ``ready_fn`` -> bool drives ``/readyz``; ``health_fn`` -> (ok, detail)
    drives ``/healthz``. Both are called per request on the handler thread,
    so they must be cheap and lock-free (the call sites pass Event checks).
    ``port=0`` binds an ephemeral port — read it back from ``.port``.

    ``post_routes`` maps a path to ``body_bytes -> (status, json_dict)`` —
    the fleet collector mounts its push sink here (obs/fleet.py), so the
    cross-host push rides the same HTTP substrate the scrape endpoint
    already owns instead of a second server stack. A handler exception
    returns 500 with the error named; there is no handler = 404, matching
    the GET side.
    """

    def __init__(
        self,
        reg: Optional[MetricsRegistry] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        ready_fn: Optional[Callable[[], bool]] = None,
        health_fn: Optional[Callable[[], Tuple[bool, str]]] = None,
        post_routes: Optional[
            Dict[str, Callable[[bytes], Tuple[int, dict]]]
        ] = None,
    ):
        self._registry = reg if reg is not None else registry()
        self._ready_fn = ready_fn or (lambda: True)
        self._health_fn = health_fn or (lambda: (True, "ok"))
        self._post_routes = dict(post_routes or {})
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: no per-scrape spam
                pass

            def _send(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            render_text(outer._registry).encode("utf-8"),
                            CONTENT_TYPE,
                        )
                    elif path == "/healthz":
                        ok, detail = outer._health_fn()
                        self._send(
                            200 if ok else 503,
                            json.dumps(
                                {"status": "ok" if ok else "unhealthy",
                                 "detail": detail}
                            ).encode("utf-8"),
                            "application/json",
                        )
                    elif path == "/readyz":
                        ready = bool(outer._ready_fn())
                        self._send(
                            200 if ready else 503,
                            json.dumps(
                                {"status": "ready" if ready else "not_ready"}
                            ).encode("utf-8"),
                            "application/json",
                        )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:  # client went away mid-scrape
                    pass

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    handler = outer._post_routes.get(path)
                    if handler is None:
                        self._send(404, b"not found\n", "text/plain")
                        return
                    length = int(self.headers.get("Content-Length", 0) or 0)
                    body = self.rfile.read(length) if length else b""
                    try:
                        status, payload = handler(body)
                    except Exception as e:  # handler bug != dead endpoint
                        status, payload = 500, {
                            "error": f"{type(e).__name__}: {e}"
                        }
                    self._send(
                        status,
                        json.dumps(payload).encode("utf-8"),
                        "application/json",
                    )
                except BrokenPipeError:  # client went away mid-reply
                    pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            daemon=True,
            name="telemetry-http",
        )
        self._thread.start()

    def add_post_route(
        self, path: str, handler: Callable[[bytes], Tuple[int, dict]]
    ) -> None:
        """Mount (or replace) a POST handler after construction — the
        serving replica mounts /predict and /reload on the endpoint
        ``GraphServer.start`` already opened, instead of a second server
        stack. Dict assignment is atomic under the GIL, so mounting while
        handler threads are serving is safe."""
        self._post_routes[str(path)] = handler

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # teardown must never raise past the owner
            pass
        self._thread.join(timeout=2.0)


def start_endpoint(
    port: int,
    ready_fn: Optional[Callable[[], bool]] = None,
    health_fn: Optional[Callable[[], Tuple[bool, str]]] = None,
    reg: Optional[MetricsRegistry] = None,
    label: str = "telemetry",
    host: str = "127.0.0.1",
) -> Optional[TelemetryHTTPServer]:
    """Best-effort endpoint construction: a bind failure (occupied port,
    no loopback) warns and returns None — the scrape surface is an
    observability aid, never a reason to take the owning plane down.
    ``host`` defaults to loopback (metrics are not public by default);
    off-host scrapers / LB probes need ``http_host: "0.0.0.0"`` (or a
    specific interface) from the owning config section."""
    import warnings

    # every scrape self-describes (torch/CUDA/devices/git): the
    # build-info gauge is published the moment a scrape surface exists
    try:
        from .telemetry import publish_build_info

        publish_build_info()
    except Exception:
        pass
    try:
        return TelemetryHTTPServer(
            reg=reg, host=host, port=int(port), ready_fn=ready_fn,
            health_fn=health_fn,
        )
    # OverflowError: an out-of-range port raises it from the socket bind,
    # and it must degrade like any other bind failure
    except (OSError, OverflowError) as e:
        warnings.warn(
            f"{label}: could not bind the metrics endpoint on {host}:{port} "
            f"({e}); /metrics///healthz//readyz are unavailable for this "
            "process",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
