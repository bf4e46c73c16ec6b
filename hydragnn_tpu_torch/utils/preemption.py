"""Preemption-safe training: checkpoint and stop cleanly on SIGTERM.

Counterpart of ``hydragnn_tpu/utils/preemption.py`` for one process. A
preempted job gets SIGTERM and a grace window. The handler only sets a flag
(async-signal-safe); the training loop checks it after every step and at
every epoch boundary, checkpoints (with the loader's cursor when it stopped
mid-epoch) and returns, so ``Training.continue`` resumes with no step lost
or replayed. The JAX package's cross-host "agreed" stop
(``preempted_global``) is the local flag on one process, as it is there at
``process_count() == 1``.

``train_validate_test`` installs the handler around its epoch loop and
restores the previous one when it returns.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

_flag = threading.Event()
# set by the training loop when it stopped (and checkpointed) on the
# preemption flag: the end-of-run save is skipped then
_global_stop = threading.Event()
_installed: Optional[int] = None
_prev_handler = None


def install() -> None:
    """Install the SIGTERM handler (main thread only; re-entrant). Clears a
    stale flag from an earlier run in the same process, which would stop
    every later run at its first step."""
    global _installed, _prev_handler
    _flag.clear()
    _global_stop.clear()
    if _installed is not None:
        return
    if threading.current_thread() is not threading.main_thread():
        return  # signal.signal is main-thread-only
    try:
        _prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        _installed = signal.SIGTERM
    except ValueError:  # an interpreter without signal support
        _installed = None


def uninstall() -> None:
    """Restore the previous SIGTERM disposition: once training is over the
    process must end on the next SIGTERM, not swallow it."""
    global _installed, _prev_handler
    if _installed is None:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        signal.signal(signal.SIGTERM, _prev_handler or signal.SIG_DFL)
    except ValueError:
        pass
    _installed = None
    _prev_handler = None


def _on_sigterm(signum, frame):
    _flag.set()
    # chain to a previously installed custom handler (a launcher's own);
    # SIG_DFL / SIG_IGN are not callables
    if callable(_prev_handler):
        _prev_handler(signum, frame)


def preempted() -> bool:
    """True once SIGTERM has been received."""
    return _flag.is_set()


def note_global_stop() -> None:
    """Record that the training loop stopped and checkpointed on the
    preemption flag (called right before its preemption save)."""
    _global_stop.set()


def global_stop_noted() -> bool:
    """True iff the training loop stopped (and checkpointed) on the
    preemption flag: ``run_training`` skips its end-of-run save then."""
    return _global_stop.is_set()


def reset() -> None:
    """Clear the flags (tests, consecutive runs in one process)."""
    _flag.clear()
    _global_stop.clear()
