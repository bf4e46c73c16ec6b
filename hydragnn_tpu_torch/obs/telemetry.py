"""Per-step train telemetry: goodput, padding waste, MFU estimate, memory,
the versioned ``metrics.jsonl`` stream, and the on-demand profiling trigger.

Counterpart of ``hydragnn_tpu/obs/telemetry.py``. Opt-in for training via
the top-level ``Telemetry`` config section (docs/CONFIG.md;
``HYDRAGNN_TELEMETRY=1/0`` overrides); the stream is written by rank 0.

What ``StepTelemetry`` measures, per window of ``interval_steps`` steps:

- **step time**: the window's elapsed time over its steps. On the card
  the window opens and closes with a CUDA event on the current stream
  (recorded before its first step's dispatch and after its last), so it is
  the device's clock, idle gaps included; PyTorch's launch queue runs far
  ahead of the device, so host dispatch time is no step time there. A
  window's events are read one window later, once they have long
  completed: one host read per window, never a stall of the step
  pipeline. Without a GPU the host clock at the same two points;
- **goodput**: real (mask-counted) graphs / nodes / edges per second;
- **padding-waste fraction** per axis: 1 - real slots / padded slots,
  overall and per pad-bucket level;
- **MFU estimate**: the FLOPs of each visited ladder level's train step
  (obs/flops.py: counted once per level, outside the steps, by
  ``torch.utils.flop_counter`` on ``meta`` tensors, so matrix products
  only) over the window's time and the card's peak (``peak_flops``);
  null on a device without a named peak;
- **memory**: peak bytes allocated per device and the host RSS.

Sinks: ``logs/<run>/metrics.jsonl`` (one JSON record per window / epoch /
run, each stamped ``{"v": 1, "ts": ...}``), the ``MetricsWriter`` mirror
(``scalars.jsonl``, TensorBoard) and the process registry (obs/registry.py),
scraped where an endpoint is mounted (``Telemetry.http_port``).

On-demand profiling: touching ``logs/<run>/profile_trigger`` (or sending
``SIGUSR1``) makes the next window's flush start a ``torch.profiler``
capture (CPU and CUDA activities) of the following ``profile_steps``
steps into ``logs/<run>/profile_on_demand/step<N>/trace.json``; it is
started and stopped between steps, on the loop's thread.
"""

from __future__ import annotations

import json
import os
import signal
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import envflags
from ..utils import ranks as _ranks
from .registry import registry

# record shapes and their version live in obs/schema.py
from .schema import METRICS_SCHEMA_VERSION as SCHEMA_VERSION

# memory gauges are the one flush component with a real price: refresh at
# most this often rather than every window
_MEMORY_REFRESH_S = 1.0

TELEMETRY_DEFAULTS: Dict[str, Any] = {
    "enabled": False,
    "interval_steps": 10,
    "http_port": None,  # None = no training-side endpoint; 0 = ephemeral
    "http_host": "127.0.0.1",  # bind interface; "0.0.0.0" for off-host
    "mfu": True,
    "jsonl": True,
    "profile_trigger": True,
    "profile_steps": 5,
    # tracing plane (obs/trace.py): spans to logs/<run>/trace.jsonl under
    # head-based sampling, trace_sample per serving request,
    # trace_interval_steps every Nth training step
    "trace": False,
    "trace_sample": 0.01,
    "trace_interval_steps": 50,
    # flight recorder (obs/flightrec.py): armed whenever the plane is on
    "flight_recorder": True,
    # per-layer activation and per-parameter-group gradient statistics and
    # the NaN provenance drill-down (obs/numerics.py); HYDRAGNN_NUMERICS=1/0
    # overrides
    "numerics": False,
    # the fleet plane (obs/fleet.py): HYDRAGNN_FLEET=1/0 overrides "fleet"
    "fleet": False,
    "fleet_collector": None,
    "fleet_collector_port": 0,
    "fleet_collector_host": "127.0.0.1",
    "fleet_straggler_factor": 2.0,
    "fleet_max_step_lag": 200,
    "fleet_stale_after_s": 30.0,
    "fleet_collective_budget": None,
    "fleet_sharding_audit_bytes": 1 << 20,
}

# dense (no sparsity) bf16 tensor-core peak FLOP/s by CUDA device name
# (torch.cuda.get_device_name). NVIDIA H100 80GB HBM3 is the H100 SXM5:
# 989.4 TFLOP/s, NVIDIA H100 Tensor Core GPU datasheet (the 1,979 TFLOP/s
# of its table is with structured sparsity).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

env_flag = envflags.env_flag


def peak_flops(device_kind: str) -> Optional[float]:
    """The named peak of a CUDA device (``PEAK_FLOPS``), or None: an
    unknown device gets no guessed peak."""
    return PEAK_FLOPS.get(str(device_kind))


def mfu_estimate(flops: float, seconds: float, device_kind: str) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over the device's peak;
    None where the device has no named peak."""
    peak = peak_flops(device_kind)
    if peak is None:
        return None
    if seconds <= 0:
        return 0.0
    return (float(flops) / float(seconds)) / peak


def _valid_collector_addr(addr: str) -> bool:
    """The 'host:port' grammar of ``Telemetry.fleet_collector``."""
    host_part, sep, port_part = addr.rpartition(":")
    return bool(sep) and bool(host_part) and port_part.isdigit()


def resolve_telemetry(config: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve the top-level ``Telemetry`` section to a complete, validated
    settings dict, as the JAX package does: unknown keys warn,
    ``HYDRAGNN_TELEMETRY`` overrides ``enabled`` and ``HYDRAGNN_NUMERICS``
    ``numerics`` (``0``/``off`` forces off, ``1`` forces on), and a bad
    value raises ``ValueError``. ``fleet: true`` (or ``HYDRAGNN_FLEET=1``)
    turns on the fleet plane (obs/fleet.py)."""
    section = dict((config or {}).get("Telemetry", {}) or {})
    unknown = sorted(set(section) - set(TELEMETRY_DEFAULTS))
    if unknown:
        warnings.warn(
            f"Telemetry config keys {unknown} are not consumed (known keys: "
            f"{sorted(TELEMETRY_DEFAULTS)}); check docs/OBSERVABILITY.md",
            stacklevel=2,
        )
        for k in unknown:
            section.pop(k)
    out = dict(TELEMETRY_DEFAULTS)
    out.update(section)
    env = env_flag("HYDRAGNN_TELEMETRY")
    if env is not None:
        out["enabled"] = env
    env_num = env_flag("HYDRAGNN_NUMERICS")
    if env_num is not None:
        out["numerics"] = env_num
    if not isinstance(out["numerics"], bool):
        raise ValueError(
            f"Telemetry.numerics must be true/false, got {out['numerics']!r}"
        )
    if int(out["interval_steps"]) < 1:
        raise ValueError(
            f"Telemetry.interval_steps must be >= 1, got "
            f"{out['interval_steps']!r}"
        )
    if int(out["profile_steps"]) < 1:
        raise ValueError(
            f"Telemetry.profile_steps must be >= 1, got "
            f"{out['profile_steps']!r}"
        )
    if out["http_port"] is not None and not (
        0 <= int(out["http_port"]) <= 65535
    ):
        raise ValueError(
            "Telemetry.http_port must be null (off), 0 (ephemeral), or a "
            f"port number <= 65535, got {out['http_port']!r}"
        )
    if not isinstance(out["http_host"], str) or not out["http_host"]:
        raise ValueError(
            "Telemetry.http_host must be a non-empty bind address, got "
            f"{out['http_host']!r}"
        )
    if not (0.0 <= float(out["trace_sample"]) <= 1.0):
        raise ValueError(
            "Telemetry.trace_sample must be a probability in [0, 1], got "
            f"{out['trace_sample']!r}"
        )
    if int(out["trace_interval_steps"]) < 1:
        raise ValueError(
            "Telemetry.trace_interval_steps must be >= 1, got "
            f"{out['trace_interval_steps']!r}"
        )
    env_fleet = env_flag("HYDRAGNN_FLEET")
    if env_fleet is not None:
        out["fleet"] = env_fleet
    if not isinstance(out["fleet"], bool):
        raise ValueError(
            f"Telemetry.fleet must be true/false, got {out['fleet']!r}"
        )
    if float(out["fleet_straggler_factor"]) <= 1.0:
        raise ValueError(
            "Telemetry.fleet_straggler_factor must be > 1 (it multiplies "
            f"the fleet median step time), got "
            f"{out['fleet_straggler_factor']!r}"
        )
    if int(out["fleet_max_step_lag"]) < 1:
        raise ValueError(
            "Telemetry.fleet_max_step_lag must be >= 1, got "
            f"{out['fleet_max_step_lag']!r}"
        )
    if float(out["fleet_stale_after_s"]) <= 0:
        raise ValueError(
            "Telemetry.fleet_stale_after_s must be > 0, got "
            f"{out['fleet_stale_after_s']!r}"
        )
    if out["fleet_collective_budget"] is not None and not (
        0.0 < float(out["fleet_collective_budget"]) <= 1.0
    ):
        raise ValueError(
            "Telemetry.fleet_collective_budget must be null (off) or a "
            f"fraction in (0, 1], got {out['fleet_collective_budget']!r}"
        )
    if int(out["fleet_sharding_audit_bytes"]) < 0:
        raise ValueError(
            "Telemetry.fleet_sharding_audit_bytes must be >= 0, got "
            f"{out['fleet_sharding_audit_bytes']!r}"
        )
    if out["fleet_collector"] is not None:
        if not _valid_collector_addr(str(out["fleet_collector"])):
            raise ValueError(
                "Telemetry.fleet_collector must be a 'host:port' address, "
                f"got {out['fleet_collector']!r}"
            )
    return out


_GIT_DESCRIBE: Optional[str] = None


def _git_describe() -> str:
    """``git describe --always --dirty`` of the checkout this package runs
    from, cached; "unknown" outside a checkout."""
    global _GIT_DESCRIBE
    if _GIT_DESCRIBE is not None:
        return _GIT_DESCRIBE
    try:
        import subprocess

        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        # trust git only if the discovered repo IS this package's root
        top = subprocess.run(
            ["git", "-C", root, "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=5,
        )
        if top.returncode != 0 or os.path.realpath(
            top.stdout.strip()
        ) != os.path.realpath(root):
            _GIT_DESCRIBE = "unknown"
            return _GIT_DESCRIBE
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        _GIT_DESCRIBE = (
            out.stdout.strip() if out.returncode == 0 and out.stdout.strip()
            else "unknown"
        )
    except Exception:
        _GIT_DESCRIBE = "unknown"
    return _GIT_DESCRIBE


def publish_build_info() -> None:
    """Publish the ``hydragnn_build_info`` info-gauge (value 1; the facts
    ride the labels): torch and CUDA versions, backend, device name and
    count, git describe, rank and world size. Idempotent by registry
    state, so a ``registry().reset()`` does not leave later scrapes
    without the series."""
    have = registry().get("hydragnn_build_info")
    if have is not None and have.samples():
        return
    torch_v = cuda_v = "unknown"
    backend, kind, devices = "cpu", "cpu", 0
    try:
        import torch

        torch_v = torch.__version__
        cuda_v = str(torch.version.cuda)
        if torch.cuda.is_available():
            backend = "cuda"
            devices = torch.cuda.device_count()
            kind = torch.cuda.get_device_name(0)
    except Exception:
        pass
    try:
        registry().gauge(
            "hydragnn_build_info",
            "Build/runtime identity of this process (value is always 1; "
            "the facts are the labels)",
            labelnames=(
                "torch", "cuda", "backend", "device", "devices", "git",
                "process_index", "process_count",
            ),
        ).set(
            1.0,
            torch=torch_v,
            cuda=cuda_v,
            backend=backend,
            device=kind,
            devices=str(devices),
            git=_git_describe(),
            process_index=str(_ranks.rank()),
            process_count=str(_ranks.world_size()),
        )
    except Exception:
        pass


def host_memory_bytes() -> float:
    """Resident-set size of this process in bytes (/proc on Linux,
    ru_maxrss as the portable fallback)."""
    try:
        with open("/proc/self/statm") as fh:
            rss_pages = int(fh.read().split()[1])
        return float(rss_pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        try:
            import resource

            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return float(rss_kb) * 1024.0
        except Exception:
            return 0.0


class MetricsStream:
    """The versioned ``metrics.jsonl`` sink: one JSON object per line, every
    record stamped with the schema version, a wall-clock timestamp and the
    rank (``host``). Rank 0 writes it, like ``MetricsWriter``."""

    def __init__(self, run_dir: str, rank0: Optional[bool] = None):
        if rank0 is None:
            rank0 = _ranks.is_primary()
        self._host = _ranks.rank()
        fname = "metrics.jsonl" if self._host == 0 else f"metrics-h{self._host}.jsonl"
        self.path = os.path.join(run_dir, fname)
        self._fh = None
        self._flushed_at = 0.0
        # HPO trial labelling: every record of a worker's stream carries
        # its HYDRAGNN_TRIAL_ID
        trial = envflags.env_str("HYDRAGNN_TRIAL_ID")
        self._trial: Optional[Any] = None
        if trial is not None:
            try:
                self._trial = int(trial)
            except ValueError:
                self._trial = trial
        if rank0:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(self.path, "a")
            # an unhandled exception still flushes the buffered tail
            import atexit

            atexit.register(self._atexit_flush)

    def _atexit_flush(self) -> None:
        try:
            if self._fh is not None:
                self._fh.flush()
        except Exception:
            pass

    def write(self, kind: str, record: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        line = {"v": SCHEMA_VERSION, "ts": round(time.time(), 3),
                "kind": kind, "host": self._host, **record}
        if self._trial is not None:
            line["trial"] = self._trial
        try:
            self._fh.write(json.dumps(line) + "\n")
            # flush ~1/s, not per record; the rare epoch/run records at once
            now = time.monotonic()
            if kind != "step_window" or now - self._flushed_at >= 1.0:
                self._fh.flush()
                self._flushed_at = now
        except (OSError, ValueError) as e:
            # observability never takes the owner down
            self._fh = None
            warnings.warn(
                f"metrics.jsonl stream failed ({e}); telemetry records are "
                "dropped for the rest of this run",
                RuntimeWarning,
                stacklevel=2,
            )

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        try:
            import atexit

            atexit.unregister(self._atexit_flush)
        except Exception:
            pass


class ProfileTrigger:
    """On-demand ``torch.profiler`` capture: arm via a touch file or
    ``SIGUSR1``; the next flush starts a capture of the following ``steps``
    steps.

    The touch file (``<run_dir>/profile_trigger``) is polled at most once
    a second and consumed (unlinked) when the capture starts; the signal
    flag is checked at every flush. The handler is installed only from
    the main thread. Captures land in step-stamped subdirectories of
    ``<run_dir>/profile_on_demand`` (``step<N>/trace.json``)."""

    def __init__(self, run_dir: str, steps: int = 5,
                 install_signal: bool = True):
        self.trigger_path = os.path.join(run_dir, "profile_trigger")
        self.out_dir = os.path.join(run_dir, "profile_on_demand")
        self.steps = max(int(steps), 1)
        self.captures = 0
        self.paths: List[str] = []
        self._signaled = False
        self._polled_at = 0.0
        self._active_until: Optional[int] = None
        self._prof = None
        self._out: Optional[str] = None
        self._prev_handler = None
        if install_signal:
            try:
                self._prev_handler = signal.signal(
                    signal.SIGUSR1, self._on_signal
                )
            except ValueError:
                pass  # not the main thread: touch-file trigger only

    def _on_signal(self, signum, frame) -> None:
        self._signaled = True  # async-signal-safe: only a flag

    def _consume_trigger(self) -> bool:
        if self._signaled:
            self._signaled = False
            return True
        now = time.monotonic()
        if now - self._polled_at < 1.0:
            return False
        self._polled_at = now
        if os.path.exists(self.trigger_path):
            try:
                os.unlink(self.trigger_path)
            except OSError:
                pass
            return True
        return False

    @property
    def active(self) -> bool:
        return self._active_until is not None

    def poll(self, global_step: int) -> None:
        """Flush-cadence check: start a capture if armed."""
        if self.active or not self._consume_trigger():
            return
        try:
            import torch

            from ..utils.profile import profiler_activities

            prof = torch.profiler.profile(activities=profiler_activities())
            prof.__enter__()
        except Exception as e:  # an epoch profile may already be tracing
            warnings.warn(
                f"on-demand profile trigger could not start a capture: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            return
        self._prof = prof
        self._out = os.path.join(self.out_dir, f"step{global_step}")
        self._active_until = int(global_step) + self.steps

    def step(self, global_step: int) -> None:
        """Per-step check: stop the capture once its window is done."""
        if self._active_until is not None and global_step >= self._active_until:
            self._stop()

    def _stop(self) -> None:
        self._active_until = None
        prof, self._prof = self._prof, None
        try:
            from ..utils.profile import _synchronize, export_trace

            _synchronize()
            prof.__exit__(None, None, None)
            self.paths.append(export_trace(prof, self._out))
            self.captures += 1
        except Exception as e:
            warnings.warn(f"on-demand profile capture failed: {e}",
                          RuntimeWarning, stacklevel=2)

    def close(self) -> None:
        if self.active:
            self._stop()
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGUSR1, self._prev_handler)
            except ValueError:
                pass
            self._prev_handler = None


def _count_true(mask) -> int:
    """The true entries of a mask; a host one counted by numpy on this
    thread (a torch sum of an edge mask fans out to the intra-op pool,
    whose wake-up on a busy host costs milliseconds a step)."""
    if mask.device.type == "cpu":
        return int(np.count_nonzero(mask.numpy()))
    return int(mask.sum())


def batch_census(batch, real_graphs: Optional[int] = None):
    """(real, padded, level key) of a host ``GraphBatch``: real counts per
    axis from its masks, padded counts from their shapes, and the level
    key ``(padded nodes, padded edges)``. The masks are loader data on the
    host: reading them never waits on the device."""
    nm, em = batch.node_mask, batch.edge_mask
    real = {
        "graphs": _count_true(batch.graph_mask) if real_graphs is None else int(real_graphs),
        "nodes": _count_true(nm),
        "edges": _count_true(em),
    }
    padded = {"graphs": int(batch.graph_mask.numel()), "nodes": int(nm.numel()),
              "edges": int(em.numel())}
    return real, padded, (int(nm.numel()), int(em.numel()))


class _Clock:
    """One window boundary: a CUDA event on the current stream of a CUDA
    ``device``, else the host clock."""

    __slots__ = ("event", "host")

    def __init__(self, device):
        self.event = None
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch

            self.event = torch.cuda.Event(enable_timing=True)
        self.mark()

    def mark(self) -> None:
        """Move the boundary to now (the event recorded again)."""
        self.host = time.perf_counter()
        if self.event is not None:
            self.event.record()

    @staticmethod
    def seconds(start: "_Clock", end: "_Clock") -> float:
        if start.event is not None and end.event is not None:
            end.event.synchronize()
            return start.event.elapsed_time(end.event) / 1e3
        return end.host - start.host


class StepTelemetry:
    """Per-step instrumentation layer of the training loop.

    Construct via ``from_config`` (None when the ``Telemetry`` section is
    absent or disabled: the loop then skips every call site); drive with
    ``step_begin()`` before a step's dispatch and ``on_step(batch, dt,
    real_graphs, numerics)`` after it, ``on_epoch`` at epoch boundaries,
    ``absorb_counters`` where the run-level totals are already on the
    host, and ``close`` in the run's ``finally``. ``device`` is the
    device the steps run on (its CUDA events time the windows)."""

    @staticmethod
    def from_config(
        config: Dict[str, Any],
        log_name: str,
        writer=None,
        log_path: str = "./logs",
        device=None,
    ) -> Optional["StepTelemetry"]:
        settings = resolve_telemetry(config)
        if not settings["enabled"]:
            return None
        return StepTelemetry(settings, log_name, writer=writer,
                             log_path=log_path, device=device)

    def __init__(self, settings: Dict[str, Any], log_name: str, writer=None,
                 log_path: str = "./logs", device=None):
        self.settings = settings
        self.log_name = log_name
        self.run_dir = os.path.join(log_path, log_name)
        self.writer = writer
        self.device = device
        self.interval = int(settings["interval_steps"])
        self.want_mfu = bool(settings["mfu"])
        self.global_step = 0
        self._flops_for: Optional[Callable[[Tuple[int, int], Any], Optional[float]]] = None
        self._flops_cache: Dict[Tuple[int, int], Optional[float]] = {}
        # one host batch of each level whose FLOPs are not counted yet
        self._level_batch: Dict[Tuple[int, int], Any] = {}
        self._mem_refreshed_at = 0.0
        self._numerics_meta: Optional[Dict[str, Any]] = None
        self._g_num: Dict[str, Any] = {}
        self._warned_peak = False
        # closed windows whose clocks are read at the next flush
        self._pending: List[Dict[str, Any]] = []
        self._reset_window()
        publish_build_info()

        # -- sinks / registry ------------------------------------------------
        self.stream = MetricsStream(self.run_dir) if settings["jsonl"] else None
        self.trigger = (
            ProfileTrigger(self.run_dir, steps=int(settings["profile_steps"]))
            if settings["profile_trigger"]
            else None
        )
        # the fleet plane (obs/fleet.py): rank 0's collector and every
        # rank's pusher; None when Telemetry.fleet is off
        self.fleet = None
        if settings.get("fleet"):
            from .fleet import FleetPlane

            self.fleet = FleetPlane.from_settings(settings, self.run_dir)
        self.http = None
        if settings["http_port"] is not None:
            from .prometheus import start_endpoint

            self.http = start_endpoint(
                int(settings["http_port"]),
                ready_fn=lambda: True,
                health_fn=lambda: (True, "training"),
                label=f"telemetry[{log_name}]",
                host=str(settings["http_host"]),
            )
        reg = registry()
        self._h_step = reg.histogram(
            "hydragnn_step_time_seconds",
            "Optimizer-step wall time (the window's device time per step)",
            labelnames=("phase",),
        )
        self._g_rate = reg.gauge(
            "hydragnn_goodput_per_second",
            "Real (mask-counted) items processed per second over the last "
            "telemetry window",
            labelnames=("axis",),
        )
        self._g_waste = reg.gauge(
            "hydragnn_padding_waste_fraction",
            "1 - real/padded slots over the last telemetry window",
            labelnames=("axis",),
        )
        self._g_waste_bucket = reg.gauge(
            "hydragnn_padding_waste_bucket_fraction",
            "Node-slot padding waste per pad-bucket specialization",
            labelnames=("bucket",),
        )
        self._g_mfu = reg.gauge(
            "hydragnn_mfu_estimate",
            "Counted matrix-product FLOPs / elapsed / the card's peak over "
            "the last window",
        )
        self._g_devmem = reg.gauge(
            "hydragnn_device_memory_peak_bytes",
            "Per-device peak bytes in use",
            labelnames=("device",),
        )
        self._g_hostmem = reg.gauge(
            "hydragnn_host_memory_rss_bytes", "Host process resident set size"
        )
        self._g_epoch = reg.gauge(
            "hydragnn_epoch", "Last completed training epoch"
        )
        self._g_loss = reg.gauge(
            "hydragnn_loss", "Per-epoch loss", labelnames=("split",)
        )
        self._g_lr = reg.gauge(
            "hydragnn_learning_rate", "Current injected learning rate"
        )
        self._c_guard = reg.counter(
            "hydragnn_guard_skipped_steps_total",
            "Non-finite steps skipped by the in-graph guard",
        )
        self._c_data_skip = reg.counter(
            "hydragnn_data_skipped_samples_total",
            "Samples dropped by the data-plane validator",
            labelnames=("reason",),
        )
        self._c_retrace = reg.counter(
            "hydragnn_retrace_violations_total",
            "Trace-sentinel violations (silent recompiles) this process",
        )
        self._c_cache_hits = reg.counter(
            "hydragnn_compile_cache_hits_total",
            "Persistent compilation cache hits this process",
        )
        self._c_cache_misses = reg.counter(
            "hydragnn_compile_cache_misses_total",
            "Persistent compilation cache misses this process",
        )
        # the always-expected series appear at 0 from the first scrape
        self._c_guard.set_total(0)
        self._c_retrace.set_total(0)
        self._c_cache_hits.set_total(0)
        self._c_cache_misses.set_total(0)

    def _reset_window(self) -> None:
        self._w_start: Optional[_Clock] = None
        self._w_end: Optional[_Clock] = None
        self._w_steps = 0
        self._w_real = {"graphs": 0, "nodes": 0, "edges": 0}
        self._w_padded = {"graphs": 0, "nodes": 0, "edges": 0}
        self._w_buckets: Dict[Tuple[int, int], Dict[str, float]] = {}
        # the steps' numerics stacks ([P,5] act, [G,5] grad) on their way
        # to the host (numerics.HostCopy): read a window later
        self._w_numerics: List[Tuple[Any, Any]] = []

    # -- wiring --------------------------------------------------------------

    def attach_flops(
        self, flops_for: Callable[[Tuple[int, int], Any], Optional[float]]
    ) -> None:
        """Install the FLOPs source: ``(level key, a host batch of that
        level) -> the train step's FLOPs``, or None when unknown. It is
        called once per level, at a flush."""
        self._flops_for = flops_for

    def attach_numerics(self, meta: Dict[str, Any]) -> None:
        """Install the numerics name tables (the train step's mutable
        meta cell: act_names/grad_names are written by the first step)."""
        self._numerics_meta = meta

    def _flops_of(self, key: Tuple[int, int]) -> Optional[float]:
        if key in self._flops_cache:
            return self._flops_cache[key]
        batch = self._level_batch.pop(key, None)
        got = None
        if self._flops_for is not None and batch is not None:
            try:
                got = self._flops_for(key, batch)
            except Exception as e:  # observability never takes the owner down
                warnings.warn(f"FLOP count of level {key} failed ({type(e).__name__}: "
                              f"{e}); its windows publish no MFU", RuntimeWarning,
                              stacklevel=2)
        self._flops_cache[key] = None if got is None else float(got)
        return self._flops_cache[key]

    # -- per-step path -------------------------------------------------------

    def step_begin(self) -> None:
        """Before a step's dispatch: opens the window at its first step."""
        if self._w_start is None:
            self._w_start = _Clock(self.device)

    def on_step(self, batch, dt: float, real_graphs: Optional[int] = None,
                numerics: Optional[Dict[str, Any]] = None) -> None:
        """Record one optimizer step: ``batch`` the host batch it stepped
        on, ``dt`` the host time of its dispatch (the JAX signature's; the
        window's time comes from its clocks), ``real_graphs`` the mask
        count the loop has anyway, ``numerics`` the step's statistics
        bundle (obs/numerics.py) when ``Telemetry.numerics`` is on, held on
        the device until a later flush."""
        if self._w_start is None:  # a caller without step_begin
            self._w_start = _Clock(self.device)
        # the window ends with its last step, not at the flush that closes
        # it (the epoch's flush comes after val/test)
        if self._w_end is None:
            self._w_end = _Clock(self.device)
        else:
            self._w_end.mark()
        self.global_step += 1
        if numerics is not None:
            from .numerics import HostCopy

            self._w_numerics.append(tuple(
                None if numerics.get(k) is None else HostCopy(numerics[k])
                for k in ("act", "grad")))
        real, padded, key = batch_census(batch, real_graphs)
        self._w_steps += 1
        for axis in ("graphs", "nodes", "edges"):
            self._w_real[axis] += real[axis]
            self._w_padded[axis] += padded[axis]
        b = self._w_buckets.setdefault(
            key, {"steps": 0, "real_nodes": 0, "padded_nodes": 0}
        )
        b["steps"] += 1
        b["real_nodes"] += real["nodes"]
        b["padded_nodes"] += padded["nodes"]
        if (self.want_mfu and self._flops_for is not None and key not in self._flops_cache
                and key not in self._level_batch):
            self._level_batch[key] = batch
        if self.trigger is not None:
            self.trigger.step(self.global_step)
        if self._w_steps >= self.interval:
            self.flush()

    def flush(self, final: bool = False) -> None:
        """Close the current window and emit every closed window but the
        newest (``final``: every one), whose clocks have long completed
        then; poll the profile trigger; refresh the memory gauges."""
        if self._w_steps:
            self._pending.append({
                "start": self._w_start, "end": self._w_end,
                "step": self.global_step, "steps": self._w_steps,
                "real": self._w_real,
                "padded": self._w_padded, "buckets": self._w_buckets,
                "numerics": self._w_numerics,
            })
            self._reset_window()
        keep = 0 if final else 1
        while len(self._pending) > keep:
            self._emit_window(self._pending.pop(0))
        self._update_memory_gauges()
        if self.trigger is not None:
            self.trigger.poll(self.global_step)

    def _device_kind(self) -> str:
        dev = self.device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            return torch.cuda.get_device_name(dev)
        return str(getattr(dev, "type", dev) or "cpu")

    def _emit_window(self, w: Dict[str, Any]) -> None:
        steps = w["steps"]
        dt = max(_Clock.seconds(w["start"], w["end"]), 1e-9)
        step_s = dt / steps
        for _ in range(steps):
            self._h_step.observe(step_s, phase="train")
        real, padded = w["real"], w["padded"]
        rates = {a: real[a] / dt for a in ("graphs", "nodes", "edges")}
        waste = {
            a: 1.0 - real[a] / max(padded[a], 1)
            for a in ("graphs", "nodes", "edges")
        }
        for a in ("graphs", "nodes", "edges"):
            self._g_rate.set(rates[a], axis=a)
            self._g_waste.set(waste[a], axis=a)
        buckets = {}
        flops = 0.0
        flops_known = self.want_mfu and self._flops_for is not None
        for key, b in w["buckets"].items():
            label = f"{key[0]}n/{key[1]}e"
            bucket_waste = 1.0 - b["real_nodes"] / max(b["padded_nodes"], 1)
            self._g_waste_bucket.set(bucket_waste, bucket=label)
            buckets[label] = {
                "steps": b["steps"],
                "padding_waste": round(bucket_waste, 4),
            }
            if flops_known:
                f = self._flops_of(key)
                if f is None:
                    flops_known = False
                else:
                    flops += f * b["steps"]
        mfu = None
        if flops_known and flops > 0:
            kind = self._device_kind()
            mfu = mfu_estimate(flops, dt, kind)
            if mfu is None:
                if not self._warned_peak:
                    self._warned_peak = True
                    warnings.warn(
                        f"no peak FLOP/s is named for device {kind!r} "
                        "(obs/telemetry.py PEAK_FLOPS): mfu_est stays null",
                        RuntimeWarning, stacklevel=2)
            else:
                self._g_mfu.set(mfu)
        num_rec = None
        if w["numerics"] and self._numerics_meta is not None:
            try:  # observability never takes the owner down
                num_rec = self._flush_numerics(w["numerics"])
            except Exception as e:
                warnings.warn(
                    f"numerics window flush failed ({type(e).__name__}: "
                    f"{e}); this window's layer statistics are dropped",
                    RuntimeWarning,
                    stacklevel=2,
                )
        if self.stream is not None:
            self.stream.write(
                "step_window",
                {
                    "step": w["step"],
                    "steps": steps,
                    "step_time_ms": round(step_s * 1e3, 3),
                    "graphs_per_sec": round(rates["graphs"], 2),
                    "nodes_per_sec": round(rates["nodes"], 1),
                    "edges_per_sec": round(rates["edges"], 1),
                    "padding_waste": round(waste["nodes"], 4),
                    "padding_waste_graphs": round(waste["graphs"], 4),
                    "padding_waste_edges": round(waste["edges"], 4),
                    "mfu_est": round(mfu, 9) if mfu is not None else None,
                    # no comm accounting yet (it comes with the distributed capture)
                    "comm_bytes_per_step": None,
                    "comm_fraction_est": None,
                    "buckets": buckets,
                },
            )
            if num_rec is not None:
                self.stream.write("numerics", {"step": w["step"], **num_rec})
        if self.fleet is not None:
            # the window IS the heartbeat: registry snapshot, step index and
            # window step time, pushed on the fleet plane's own thread
            self.fleet.on_window(w["step"], step_time_s=step_s, comm_fraction_est=None)
        if self.writer is not None:
            self.writer.add_scalars(
                {
                    "telemetry/step_time_ms": step_s * 1e3,
                    "telemetry/graphs_per_sec": rates["graphs"],
                    "telemetry/padding_waste": waste["nodes"],
                    **({"telemetry/mfu_est": mfu} if mfu is not None else {}),
                },
                w["step"],
            )

    def _numerics_gauges(self):
        if not self._g_num:
            reg = registry()
            self._g_num = {
                "max_abs": reg.gauge(
                    "hydragnn_numerics_max_abs",
                    "Per-tensor max |x| over the last telemetry window "
                    "(obs/numerics.py probes)",
                    labelnames=("kind", "tensor"),
                ),
                "rms": reg.gauge(
                    "hydragnn_numerics_rms",
                    "Per-tensor rms over the last telemetry window",
                    labelnames=("kind", "tensor"),
                ),
                "underflow": reg.gauge(
                    "hydragnn_numerics_bf16_underflow_fraction",
                    "Fraction of (real) elements below the smallest normal "
                    "bf16 magnitude over the last window",
                    labelnames=("kind", "tensor"),
                ),
                "nonfinite": reg.counter(
                    "hydragnn_numerics_nonfinite_total",
                    "Non-finite elements seen per tensor (windows "
                    "accumulate)",
                    labelnames=("kind", "tensor"),
                ),
            }
        return self._g_num

    @staticmethod
    def _combine_numerics(stacks):
        """Merge per-step [P,5] stacks over the window: max-abs by max, the
        summed moments by sum. A host [P,5] array or None."""
        import torch

        arrs = [t for t in (s.get() for s in stacks if s is not None) if t.numel()]
        if not arrs:
            return None
        stacked = torch.stack(arrs).double().numpy()  # [W, P, 5]
        out = np.empty(stacked.shape[1:], np.float64)
        out[:, 0] = stacked[:, :, 0].max(axis=0)
        out[:, 1:] = stacked[:, :, 1:].sum(axis=0)
        return out

    @staticmethod
    def _json_stat(v: float):
        # non-finite stats are the signal: strings keep the stream strict JSON
        return float(v) if np.isfinite(v) else str(v)

    def _flush_numerics(self, stacks) -> Optional[Dict[str, Any]]:
        """Aggregate one window's numerics stacks, publish the per-tensor
        gauges, and return the ``numerics`` record body."""
        from .numerics import finalize_stats

        acts = self._combine_numerics([a for a, _ in stacks])
        grads = self._combine_numerics([g for _, g in stacks])
        meta = self._numerics_meta or {}
        gauges = self._numerics_gauges()
        record: Dict[str, Any] = {}
        for kind, names, table in (
            ("activation", meta.get("act_names"), acts),
            ("gradient", meta.get("grad_names"), grads),
        ):
            if table is None:
                continue
            section: Dict[str, Any] = {}
            for i in range(table.shape[0]):
                name = names[i] if names and i < len(names) else f"{kind}{i}"
                st = finalize_stats(table[i])
                gauges["max_abs"].set(st["max_abs"], kind=kind, tensor=name)
                gauges["rms"].set(st["rms"], kind=kind, tensor=name)
                gauges["underflow"].set(st["bf16_underflow"], kind=kind, tensor=name)
                if st["nonfinite"] > 0:
                    gauges["nonfinite"].inc(st["nonfinite"], kind=kind, tensor=name)
                section[name] = {
                    "max_abs": self._json_stat(st["max_abs"]),
                    "rms": self._json_stat(st["rms"]),
                    "nonfinite": int(st["nonfinite"]),
                    "bf16_underflow": round(st["bf16_underflow"], 6),
                }
            record["activations" if kind == "activation" else "gradients"] = section
        return record or None

    def _update_memory_gauges(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._mem_refreshed_at < _MEMORY_REFRESH_S:
            return
        self._mem_refreshed_at = now
        try:
            from ..utils.profile import peak_memory_stats

            for dev, peak in peak_memory_stats().items():
                self._g_devmem.set(peak, device=dev)
        except Exception:
            pass
        self._g_hostmem.set(host_memory_bytes())

    # -- epoch / run path ----------------------------------------------------

    def on_epoch(self, epoch: int, scalars: Dict[str, float],
                 filler: bool = False) -> None:
        """Epoch-boundary record. ``filler=True`` marks rows whose val/test
        entries are carried forward (mid-epoch preemption stop) rather than
        measured."""
        self.flush(final=True)
        self._g_epoch.set(int(epoch))
        for split, v in scalars.items():
            if split == "lr":
                self._g_lr.set(float(v))
            else:
                self._g_loss.set(float(v), split=split)
        if self.stream is not None:
            self.stream.write(
                "epoch",
                {
                    "epoch": int(epoch),
                    **{k: float(v) for k, v in scalars.items()},
                    "filler": bool(filler),
                },
            )

    def absorb_counters(
        self,
        guard_skipped: Optional[int] = None,
        data_skipped: Optional[Dict[str, int]] = None,
        retrace_violations: Optional[int] = None,
        compile_metrics: Optional[Dict[str, float]] = None,
    ) -> None:
        """Absorb externally maintained monotonic totals (idempotent:
        counters max-merge). ``guard_skipped`` must be a monotonic event
        count: the loop accumulates positive deltas of the state's counter,
        which a rollback restore can lower. ``retrace_violations`` and
        ``compile_metrics`` are the compile plane's (train/compile_plane.py:
        the sentinel's violations, the kernel libraries found built or
        built)."""
        if guard_skipped is not None:
            self._c_guard.set_total(int(guard_skipped))
        for reason, count in (data_skipped or {}).items():
            self._c_data_skip.set_total(int(count), reason=reason)
        if retrace_violations is not None:
            self._c_retrace.set_total(int(retrace_violations))
        if compile_metrics:
            self._c_cache_hits.set_total(int(compile_metrics["cache_hits"]))
            self._c_cache_misses.set_total(int(compile_metrics["cache_misses"]))

    def run_record(self, info: Dict[str, Any]) -> None:
        if self.stream is not None:
            self.stream.write("run", dict(info))

    @property
    def endpoint_port(self) -> Optional[int]:
        return self.http.port if self.http is not None else None

    def close(self) -> None:
        self.flush(final=True)
        if self.fleet is not None:
            self.fleet.close(final_step=self.global_step)
            self.fleet = None
        if self.trigger is not None:
            self.trigger.close()
        if self.http is not None:
            self.http.close()
            self.http = None
        if self.stream is not None:
            self.stream.close()
