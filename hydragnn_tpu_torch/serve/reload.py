"""Hot checkpoint reload: watch a run dir's ``latest`` pointer and swap
verified checkpoints into a live server without dropping requests.

Counterpart of ``hydragnn_tpu/serve/reload.py``. The port's server serves
from CUDA graphs that hold the addresses of its weights, so a swap never
rebinds a tensor: the candidate is restored into a standby copy of the
model on the host (``GraphServer.restore_template``), prepared into the
served form (cast or quantized, ``GraphServer._install_state``), and the
serve loop copies it into the served tensors in place, between batches.

A training run (or a continuous-training fleet, ROADMAP item 5) keeps
publishing checkpoints through the atomic pointer-commit protocol
(train/checkpoint.py); the watcher polls the pointer and, on change,
restores the candidate through the digest-verified walk-back chain into a
standby state (``load_inference_state``: the model's tensors only, no
optimizer state). The swap is staged via ``GraphServer._install_state``
and taken by the serve loop *between* batches, so in-flight batches keep the
weights they started with.

Failure policy: a corrupt candidate (sha256 mismatch, torn write,
deserialization failure) is REJECTED and the current weights keep serving —
the walk-back chain restoring an *older* file than the pointer names is
treated the same (installing it would silently downgrade the server). Every
rejection is counted and warned once; the next pointer change triggers a
fresh attempt.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

from ..train.checkpoint import latest_checkpoint_entry, load_inference_state


class CheckpointWatcher:
    """Daemon poller: ``latest`` pointer -> verified standby restore ->
    atomic between-batch swap. ``stats`` counts installs and rejections."""

    def __init__(
        self,
        server,
        log_name: str,
        path: str = "./logs",
        poll_s: float = 2.0,
        initial_entry: Optional[str] = None,
    ):
        self.server = server
        self.log_name = log_name
        self.path = path
        self.poll_s = max(float(poll_s), 0.05)
        self._last_entry = initial_entry
        self._stop = threading.Event()
        self.installed = 0
        self.rejected = 0
        self._thread = threading.Thread(
            target=self._main, daemon=True, name="serve-ckpt-watch"
        )

    def start(self) -> "CheckpointWatcher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def poll_once(self) -> Optional[str]:
        """One poll step (also the test hook): returns ``installed``,
        ``rejected``, or None when the pointer is unchanged/absent."""
        with self.server.reload_lock:
            return self._poll_locked()

    def _poll_locked(self) -> Optional[str]:
        entry = latest_checkpoint_entry(self.log_name, self.path)
        if entry is None or entry == self._last_entry:
            return None
        # one attempt per pointer value: a corrupt candidate will not heal,
        # so re-trying it every poll would just spam the log
        self._last_entry = entry
        try:
            # restore into the standby f32 model: never into the served
            # tensors, which a batch may be reading; _install_state applies
            # the precision gate
            state, loaded_from = load_inference_state(
                self.server.restore_template, self.log_name, self.path,
            )
        except Exception as e:  # noqa: BLE001 — keep serving current weights
            self.rejected += 1
            self._emit_event("reject", entry, detail=f"{type(e).__name__}: {e}")
            warnings.warn(
                f"hot reload: candidate {entry!r} of run {self.log_name!r} "
                f"failed to restore ({type(e).__name__}: {e}); keeping the "
                f"current weights ({self.server.current_checkpoint})",
                RuntimeWarning,
                stacklevel=2,
            )
            return "rejected"
        if loaded_from != entry:
            # the verified walk-back chain fell PAST the candidate: the
            # pointer names a corrupt file. Installing the older file it
            # found instead would be a silent downgrade — keep current.
            self.rejected += 1
            self._emit_event(
                "reject", entry, detail=f"walk-back restored {loaded_from!r}"
            )
            warnings.warn(
                f"hot reload: candidate {entry!r} failed verification (the "
                f"restore chain fell back to {loaded_from!r}); keeping the "
                f"current weights ({self.server.current_checkpoint})",
                RuntimeWarning,
                stacklevel=2,
            )
            return "rejected"
        try:
            installed = self.server._install_state(state, entry)
        except Exception as e:  # noqa: BLE001 — gate refusals keep serving
            # the install-time precision gate refused the candidate (int8
            # accuracy drift past Serving.quantization.max_error): keep
            # the current weights, same verdict as a corrupt candidate.
            # The gate already emitted its own typed quant_drift event.
            self.rejected += 1
            self._emit_event(
                "reject", entry, detail=f"{type(e).__name__}: {e}"
            )
            warnings.warn(
                f"hot reload: candidate {entry!r} refused at install "
                f"({type(e).__name__}: {e}); keeping the current weights "
                f"({self.server.current_checkpoint})",
                RuntimeWarning,
                stacklevel=2,
            )
            return "rejected"
        if not installed:
            # the server refused the stage: it is draining/closing and the
            # serve loop will never take another swap. Count a rejection
            # (not an install — nothing was staged) and let the standby
            # state drop here instead of leaking it past close().
            self.rejected += 1
            self._emit_event(
                "reject", entry, detail="server draining/closed at install"
            )
            return "rejected"
        self.installed += 1
        self._emit_event("swap", entry)
        return "installed"

    def _emit_event(self, outcome: str, entry: str, detail: str = "") -> None:
        """Typed reload incident (obs/events.py) — swap/reject verdicts in
        the flight-recorder window; never allowed to fail the watcher."""
        try:
            from ..obs.events import EV_RELOAD_REJECT, EV_RELOAD_SWAP
            from ..obs.events import emit as _emit

            kind = EV_RELOAD_SWAP if outcome == "swap" else EV_RELOAD_REJECT
            attrs = {"candidate": entry, "run": self.log_name}
            if detail:
                attrs["detail"] = detail
            _emit(
                kind,
                severity="info" if outcome == "swap" else "warn",
                **attrs,
            )
        except Exception:
            pass

    def _main(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher must survive
                warnings.warn(
                    f"hot reload watcher error: {type(e).__name__}: {e}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self._stop.wait(self.poll_s)
