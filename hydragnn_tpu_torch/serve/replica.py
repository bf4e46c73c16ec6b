"""Serving-fleet replica worker: one GraphServer process addressable over
HTTP (docs/SERVING.md "Fleet").

Counterpart of ``hydragnn_tpu/serve/replica.py``, with its protocol.
``python -m hydragnn_tpu_torch.serve.replica <config.json>`` builds a server via
``api.run_server`` (same checkpoint restore, ladder warm-up, sentinel, and
telemetry wiring as a standalone server) and then mounts the fleet protocol
on the telemetry endpoint the server already opened:

- ``POST /predict`` — wire-codec graph in, wire-codec prediction out;
  typed failures return their stable error code (serve/errors.py) with an
  HTTP status in the matching class, so transport-level and protocol-level
  failures stay distinguishable at the router;
- ``POST /reload`` — ``{"poll": true}`` takes one CheckpointWatcher poll
  (the ReplicaManager staggers these across the fleet for rolling
  reloads); ``{"entry": "..."}`` force-installs one specific verified
  checkpoint (the rollback path); ``{}`` reports the current checkpoint;
- ``POST /stats`` — the server's ``stats()`` dict (the smoke and the
  manager's reload probe read ``current_checkpoint`` and error counters
  here) and the kernels' launches in this process (``kernel_launches``);
- ``GET /readyz`` / ``/healthz`` / ``/metrics`` — unchanged from the
  single-server deployment; the manager health-gates on /readyz.

The replica runs on the card its environment shows it
(``CUDA_VISIBLE_DEVICES``, set by the ReplicaManager) and fails at start
without one, unless the config's top-level ``"device"`` asks for another
(``"cpu"`` in the tests).

Identity and wiring come from the environment the ReplicaManager sets:
``HYDRAGNN_FLEET_HOST_INDEX``/``_COUNT`` (the replica's fleet identity —
events land host-suffixed in ``events-h<i>.jsonl`` and the doctor merges
them), ``HYDRAGNN_SERVE_RENDEZVOUS`` (directory to publish
``replica_<i>.json`` with the bound port, tmp+rename atomic), and
``HYDRAGNN_SERVE_FLEET_PUSH`` (the manager's collector URL; a FleetPusher
heartbeat carries this replica's serve gauges there ~1/s).

Chaos drills (utils/faultinject.py): ``maybe_replica_kill`` /
``maybe_replica_wedge`` / ``maybe_replica_slow`` run at the top of every
/predict, keyed by this replica's fleet index and a per-process request
counter.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Tuple

from ..utils import faultinject
from ..utils.envflags import env_str
from .errors import (
    DeadlineExceededError,
    InvalidRequestError,
    QueueFullError,
    ServeError,
    ServerClosedError,
    ServerDrainingError,
    SheddedError,
)

# stable code -> HTTP status for /predict failures: 4xx = the request (or
# its timing) is the problem, 503 = this replica cannot take it (retry
# elsewhere), 500 = the serving step itself failed
_STATUS_BY_CODE = {
    InvalidRequestError.code: 400,
    QueueFullError.code: 429,
    SheddedError.code: 429,
    DeadlineExceededError.code: 504,
    ServerDrainingError.code: 503,
    ServerClosedError.code: 503,
}

_READY_TIMEOUT_S = 600.0
_HEARTBEAT_S = 1.0


def _error_response(err: BaseException) -> Tuple[int, Dict[str, Any]]:
    from . import wire

    status = _STATUS_BY_CODE.get(getattr(err, "code", ""), 500)
    return status, wire.encode_error(err)


class ReplicaApp:
    """The fleet protocol mounted over one started GraphServer. Separated
    from ``main()`` so tests can drive the handlers in-process without a
    subprocess or a real config."""

    def __init__(self, server, watcher, replica_index: int):
        self.server = server
        self.watcher = watcher
        self.index = int(replica_index)
        self._req_seq = itertools.count()

    # -- handlers (TelemetryHTTPServer post routes) --------------------------

    def handle_predict(self, body: bytes) -> Tuple[int, Dict[str, Any]]:
        from . import wire

        idx = next(self._req_seq)
        # chaos drills: dead / wedged / slow replica models (no-op unarmed)
        faultinject.maybe_replica_kill(self.index, idx)
        faultinject.maybe_replica_wedge(self.index, idx)
        faultinject.maybe_replica_slow(self.index)
        try:
            obj = wire.loads(body)
            graph = wire.decode_graph(obj)
            deadline_s = obj.get("deadline_s")
            handle = self.server.submit(
                graph,
                deadline_s=float(deadline_s) if deadline_s else None,
            )
            result = handle.result(
                timeout=float(deadline_s) if deadline_s else None
            )
            return 200, wire.encode_prediction(result)
        except ServeError as e:
            return _error_response(e)
        except Exception as e:  # noqa: BLE001 — must answer, not hang
            return _error_response(
                ServeError(f"replica {self.index}: {type(e).__name__}: {e}")
            )

    def handle_reload(self, body: bytes) -> Tuple[int, Dict[str, Any]]:
        try:
            req = json.loads(body.decode("utf-8")) if body.strip() else {}
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return 400, {"error": {"code": "invalid_request",
                                   "message": f"reload body not JSON: {e}"}}
        try:
            if req.get("entry"):
                return self._reload_entry(str(req["entry"]))
            if req.get("poll"):
                outcome = (
                    self.watcher.poll_once()
                    if self.watcher is not None else None
                )
                return 200, {
                    "status": outcome or "unchanged",
                    "current": self.server.current_checkpoint,
                }
            return 200, {"status": "noop",
                         "current": self.server.current_checkpoint}
        except Exception as e:  # noqa: BLE001
            return 500, {"error": {"code": "serve_error",
                                   "message": f"{type(e).__name__}: {e}"}}

    def _reload_entry(self, entry: str) -> Tuple[int, Dict[str, Any]]:
        """Force-install one specific verified checkpoint — the rolling
        rollback. No walk-back: a rollback restores exactly the prior
        entry or fails loudly."""
        from ..train.checkpoint import load_inference_entry

        with self.server.reload_lock:
            try:
                state = load_inference_entry(self.server.restore_template,
                                             self.server.log_name, entry)
            except (FileNotFoundError, ValueError) as e:
                return 409, {"error": {"code": "serve_error", "message": str(e)}}
            return self._install_entry(state, entry)

    def _install_entry(self, state, entry: str) -> Tuple[int, Dict[str, Any]]:
        try:
            installed = self.server._install_state(state, entry)
        except Exception as e:  # noqa: BLE001 — typed gate refusal
            # int8 accuracy gate refused the entry (QuantizationDriftError
            # et al): answer "rejected", keep the current weights serving
            return 409, {"status": "rejected", "error": {
                "code": getattr(e, "code", "serve_error"),
                "message": f"{type(e).__name__}: {e}",
            }}
        if not installed:
            return 503, {"error": {
                "code": ServerDrainingError.code,
                "message": "server draining/closed; reload refused",
            }}
        # NOTE: the watcher's _last_entry still holds the pointer value it
        # last attempted, so a poll will not re-install the rolled-back-from
        # candidate; the rollback holds until the pointer changes again.
        return 200, {"status": "installed", "current": entry}

    def handle_stats(self, body: bytes) -> Tuple[int, Dict[str, Any]]:
        try:
            from ..ops import launch_counts

            stats = self.server.stats()
            stats["replica_index"] = self.index
            stats["kernel_launches"] = launch_counts()
            return 200, stats
        except Exception as e:  # noqa: BLE001
            return 500, {"error": {"code": "serve_error",
                                   "message": f"{type(e).__name__}: {e}"}}

    def mount(self) -> bool:
        http = getattr(self.server, "_http", None)
        if http is None:
            return False
        http.add_post_route("/predict", self.handle_predict)
        http.add_post_route("/reload", self.handle_reload)
        http.add_post_route("/stats", self.handle_stats)
        return True


def _write_rendezvous(rendezvous_dir: str, index: int,
                      port: int) -> None:
    """Atomically publish this replica's address for the manager
    (tmp+rename, the checkpoint pointer discipline — the manager must
    never read a torn JSON)."""
    os.makedirs(rendezvous_dir, exist_ok=True)
    path = os.path.join(rendezvous_dir, f"replica_{index}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"replica": index, "port": int(port),
                   "pid": os.getpid()}, f)
    os.replace(tmp, path)


def _heartbeat_loop(app: ReplicaApp, push_url: str, index: int,
                    count: int) -> None:
    """Push this replica's registry (serve gauges included) to the
    manager's collector ~1/s until the server stops — the liveness signal
    the manager's staleness sweep watches, and the queue-depth feed the
    router balances on."""
    from ..obs.fleet import FleetPusher

    pusher = FleetPusher(push_url, host=index, host_count=count)
    try:
        while not app.server._stop.is_set():
            stats_step = app.server._stats.get("completed", 0)
            pusher.on_window(
                step=int(stats_step),
                step_time_s=float(app.server._per_graph_s) or None,
            )
            time.sleep(_HEARTBEAT_S)
    finally:
        pusher.close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: python -m hydragnn_tpu_torch.serve.replica <config.json>",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from .. import api
    from ..config.config import load_config
    from ..obs.fleet import host_identity

    index, count = host_identity()
    config = load_config(argv[0])
    t_import = time.perf_counter()
    server = api.run_server(config, device=config.get("device"), install_sigterm=True)
    t_built = time.perf_counter()
    app = ReplicaApp(server, getattr(server, "_watcher", None), index)
    if not app.mount():
        print(
            f"replica {index}: no HTTP endpoint (Serving.http_port < 0 or "
            "bind failed); a fleet replica must be addressable",
            file=sys.stderr,
        )
        server.close(drain=False)
        return 1
    if not server.wait_ready(timeout=_READY_TIMEOUT_S):
        print(f"replica {index}: warm-up failed: {server.failed}",
              file=sys.stderr)
        server.close(drain=False)
        return 1
    rendezvous = env_str("HYDRAGNN_SERVE_RENDEZVOUS")
    if rendezvous:
        _write_rendezvous(rendezvous, index, server.http_port)
    push_url = env_str("HYDRAGNN_SERVE_FLEET_PUSH")
    if push_url:
        threading.Thread(
            target=_heartbeat_loop, args=(app, push_url, index, count),
            daemon=True, name=f"replica-{index}-heartbeat",
        ).start()
    t_ready = time.perf_counter()
    print(f"REPLICA_READY index={index} port={server.http_port} in "
          f"{t_ready - t_start:.2f} s (imports {t_import - t_start:.2f} s, run_server "
          f"{t_built - t_import:.2f} s, warm-up {t_ready - t_built:.2f} s)", flush=True)
    # serve until SIGTERM (drain) or close; the drained event fires when
    # every admitted request was answered
    try:
        while not server._drained.wait(timeout=0.5):
            if server.failed is not None:
                print(f"replica {index}: serve loop failed: {server.failed}",
                      file=sys.stderr)
                server.close(drain=False)
                return 1
    except KeyboardInterrupt:
        pass
    server.close()
    print(f"REPLICA_EXIT index={index}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
