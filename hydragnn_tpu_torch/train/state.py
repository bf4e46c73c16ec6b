"""Training state: the model, its optimizer, the step counters and the
guard's copies; the inference state; the loader's position.

Counterpart of ``hydragnn_tpu/train/state.py``. ``TrainState``: the
parameters and batch-norm buffers live in the model, the moments in the
optimizer; ``held`` lists every tensor a step may change. ``step`` and the
guard's ``skipped_steps`` (total) and ``consecutive_skips`` (reset by any
good step) are int64 tensors on the model's device, advanced there by the
train step. ``guard`` holds the non-finite step guard's copies of
``held`` (train/guard.py), made once here; None turns the guard off.

``TrainState.to_payload`` is what a checkpoint holds (train/checkpoint.py):
the model's ``state_dict`` (parameters and batch-norm buffers), the
optimizer's ``state_dict``, the three counters and the learning rate, every
tensor copied to the CPU, so a checkpoint written on the card restores on
the CPU and the other way round. ``load_payload`` copies the values back
in place: every tensor of ``held`` stays the same object, so the guard's
copies (views of its flat buffers over ``held``) stay valid after a
restore. ``InferenceState`` is the optimizer-free restore target of
prediction and serving; ``LoaderState`` the loader's position beside a
mid-epoch checkpoint.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..device import module_device
from .guard import StepCopies, held_tensors


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: torch.Tensor
    skipped_steps: torch.Tensor
    consecutive_skips: torch.Tensor
    held: List[torch.Tensor]
    guard: Optional[StepCopies]
    # where a distributed run placed the state (parallel/engine.py
    # place_state); None for one process
    placement: Optional[Any] = None

    @staticmethod
    def create(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               guard: bool = True) -> "TrainState":
        """The state of a fresh run; ``guard`` (on by default) makes the
        non-finite step guard's copies, so every train step is guarded."""
        dev = module_device(model)
        zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)  # noqa: E731
        held = held_tensors(model, optimizer)
        return TrainState(model, optimizer, zero(), zero(), zero(), held,
                          StepCopies(held) if guard else None)

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self

    def _counters(self) -> List[torch.Tensor]:
        return [self.step, self.skipped_steps, self.consecutive_skips]

    def state_dict(self):
        """A copy of everything a step changes (``held``, the counters) and
        the learning rate, for ``load_state_dict``."""
        return {"tensors": [t.clone() for t in self.held + self._counters()],
                "lr": self.learning_rate}

    @torch.no_grad()
    def load_state_dict(self, sd) -> None:
        """Copy ``sd`` back in place (the guard's copies stay valid)."""
        torch._foreach_copy_(self.held + self._counters(), sd["tensors"])
        self.with_learning_rate(sd["lr"])

    def to_payload(self) -> Dict[str, Any]:
        """The checkpoint payload: CPU copies of the model's and the
        optimizer's state dicts, the counters and the learning rate. A
        placed state gathers the whole model's (every rank calls it)."""
        if self.placement is not None:
            return self.placement.to_payload(self)
        return {"format": PAYLOAD_FORMAT,
                "model": _to_cpu(self.model.state_dict()),
                "optimizer": _to_cpu(self.optimizer.state_dict()),
                "step": int(self.step), "skipped_steps": int(self.skipped_steps),
                "consecutive_skips": int(self.consecutive_skips),
                "lr": self.learning_rate}

    @torch.no_grad()
    def load_payload(self, payload: Dict[str, Any]) -> "TrainState":
        """Copy a ``to_payload`` dict into this state in place. A payload of
        another structure raises ``ValueError`` before anything is
        copied. A placed state takes its part of the whole model's."""
        if self.placement is not None:
            self.placement.load_payload(self, payload)
            return self
        _check_model(self.model, payload)
        writes = _optimizer_writes(self.optimizer, payload["optimizer"])
        self.model.load_state_dict(payload["model"], strict=True)
        for have, k, v in writes:
            if torch.is_tensor(v):
                have[k].copy_(v)
            else:
                have[k] = v
        for t, k in zip(self._counters(), ("step", "skipped_steps", "consecutive_skips")):
            t.fill_(int(payload[k]))
        return self.with_learning_rate(payload["lr"])


PAYLOAD_FORMAT = "hydragnn_tpu_torch.TrainState/1"


def _to_cpu(tree):
    """``tree`` with every tensor replaced by a CPU copy of its own (a
    view of a larger storage would otherwise save the whole storage)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def _check_model(model: torch.nn.Module, payload) -> None:
    """The payload's format, and its model tensors against ``model``'s by
    name and shape."""
    if not isinstance(payload, dict) or payload.get("format") != PAYLOAD_FORMAT:
        got = payload.get("format") if isinstance(payload, dict) else type(payload).__name__
        raise ValueError(f"not a {PAYLOAD_FORMAT} checkpoint payload (format {got!r})")
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in payload["model"].items()}
    if have != want:
        diff = sorted(k for k in set(have) | set(want) if have.get(k) != want.get(k))
        raise ValueError(f"the checkpoint's model differs from this one in {diff[:8]}")


def _optimizer_writes(opt: torch.optim.Optimizer, saved: Dict[str, Any]):
    """``(state dict, key, saved value)`` for every entry of ``opt``'s
    per-parameter state, checked against the saved ``state_dict``: the
    values are copied into the existing tensors in place
    (``Optimizer.load_state_dict`` would replace them). The learning rate
    is the payload's own key; the other hyperparameters stay as the config
    made them."""
    groups, saved_groups = opt.param_groups, saved["param_groups"]
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in saved_groups]:
        raise ValueError("the checkpoint's optimizer has another parameter layout")
    writes = []
    for group, saved_group in zip(groups, saved_groups):
        for p, i in zip(group["params"], saved_group["params"]):
            have, want = opt.state.get(p, {}), saved["state"].get(i, {})
            if set(have) != set(want):
                raise ValueError(f"optimizer state keys {sorted(want)} in the checkpoint, "
                                 f"{sorted(have)} here")
            for k, v in want.items():
                if torch.is_tensor(v) and have[k].shape != v.shape:
                    raise ValueError(f"optimizer state {k!r} of shape {tuple(v.shape)} in the "
                                     f"checkpoint, {tuple(have[k].shape)} here")
                writes.append((have, k, v))
    return writes


@dataclasses.dataclass
class InferenceState:
    """The model and the step it was saved at: no optimizer state. The
    restore target of ``run_prediction`` and ``run_server``
    (``checkpoint.load_inference_state`` copies only the payload's model
    tensors into ``model``)."""

    model: torch.nn.Module
    step: int = 0

    @torch.no_grad()
    def load_payload(self, payload: Dict[str, Any]) -> "InferenceState":
        _check_model(self.model, payload)
        self.model.load_state_dict(payload["model"], strict=True)
        return dataclasses.replace(self, step=int(payload.get("step", 0)))


def cast_inference_weights(state, dtype):
    """A copy of ``state`` (an ``InferenceState``, or anything with a
    ``model`` and a ``step``) whose model's floating parameters are cast to
    ``dtype``: the ``Serving.weights_dtype: bfloat16`` step. Batch-norm
    statistics (buffers) keep f32: running moments, a rounding error of
    the parameters' bytes. Integer leaves pass through. The model's layers
    promote (flax promotion, ``models/layers.py`` ``dense``), so on f32
    inputs the products run in f32 on the bf16-valued weights, as the JAX
    package's do.

    ``dtype="int8"`` is a quantization, not a cast: the serving plane's
    weight-only transform (serve/quantize.py ``quantize_weights``, a
    ``QuantizedInferenceState``); the server adds calibration and the
    accuracy gate on top."""
    if str(dtype) == "int8":
        from ..serve.quantize import quantize_weights

        return quantize_weights(state)
    dt = getattr(torch, str(dtype).replace("torch.", ""))
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dt)
    return dataclasses.replace(state, model=model)


@dataclasses.dataclass(frozen=True)
class LoaderState:
    """The loader's position, saved beside the checkpoint of a mid-epoch
    preemption stop (``checkpoint.save_loader_state``). The shuffle is a
    pure function of (seed, epoch) (``GraphLoader._indices``), so resuming
    at (``epoch``, ``next_batch``) replays the remaining batches of the
    interrupted epoch in the same order. ``seed`` and ``num_batches`` guard
    against resuming under another recipe (seed, dataset or batch size):
    ``run_training`` then ignores the record with a warning."""

    epoch: int
    next_batch: int
    seed: int = 0
    num_batches: int = 0

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LoaderState":
        return LoaderState(epoch=int(d["epoch"]), next_batch=int(d["next_batch"]),
                           seed=int(d.get("seed", 0)), num_batches=int(d.get("num_batches", 0)))
