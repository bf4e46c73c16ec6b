"""Int8 quantized inference plane.

Counterpart of ``hydragnn_tpu/serve/quantize.py``: the same modes, layer
selection, calibration, accuracy gate, typed error, event and snapshot
discipline, on the port's modules.

- **weights**: per-channel symmetric int8 with f32 scales (ops/quant.py).
  Every quantized dense layer becomes a ``QuantizedDense`` holding its int8
  weight and its scale as buffers; its ``weight`` attribute is the
  dequantized f32 tensor, so code that reads a layer's weight directly
  (K2 reads ``edge_lin2.weight``) sees floats, made inside the served
  forward (and inside each level's CUDA graph) from the int8 buffer;
- **activations** (``w8a8``): static activation scales calibrated from
  the numerics probes' max-abs statistics (obs/numerics.py ``probe`` /
  ``collecting``) over ``Serving.quantization.calibration_batches``
  template batches. A calibrated 2-D layer runs int8 x int8 with an int32
  accumulator (``torch._int_mm`` on the card). Layers the calibration
  never observed (a weight read directly, a branch bank, whose JAX
  counterpart runs under ``vmap``) stay weight-only: quantization never
  changes which code path a layer executes;
- **the gate**: every install (the server's construction, a hot reload, a
  replica's forced reload) compares quantized and full-precision
  predictions on the warmed ladder's template batches and refuses the
  state when the relative max error crosses
  ``Serving.quantization.max_error``: ``QuantizationDriftError`` and a
  ``quant_drift`` event; the previous weights keep serving.

Selection works on the flax paths of the parameters (bridge.py
``flax_leaves``, the map ``load_jax_variables`` uses), so one config
excludes the same layers in both packages: only ``kernel`` leaves of rank
>= 2 quantize (batch-norm scales, biases and statistics stay f32
structurally), each head's output layer (the highest-indexed ``Dense_k``
under a ``heads*`` scope) is excluded, and ``Serving.quantization.exclude``
adds substring patterns.

Snapshot: ``<entry>.quant-<mode>.npz`` beside the checkpoint, written with
the checkpoint plane's ``atomic_write`` and sha256 sidecar: replicas load
int8 directly, and a torn or corrupt snapshot falls back to quantizing.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import io
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..bridge import flax_leaves, flax_path
from ..models.layers import BankedDense, Dense, dense
from ..ops.quant import (
    INT8_MAX,
    dequantize,
    int8_matmul,
    pad_weight,
    quantize_activations,
    quantize_per_channel,
)
from .errors import ServeError

#: bump on any change to the snapshot layout: a loader seeing another
#: version treats the artifact as absent and re-quantizes
SNAPSHOT_FORMAT_VERSION = 1

MODES = ("weight_only", "w8a8")


class QuantizationDriftError(ServeError):
    """The accuracy gate refused a quantized state: its predictions
    drifted past ``Serving.quantization.max_error`` relative to full
    precision on the template batches. Raised at install time: the
    current weights keep serving."""

    code = "quant_drift"

    def __init__(self, message: str, max_error: float = 0.0,
                 limit: float = 0.0,
                 per_head: Optional[Dict[str, float]] = None):
        super().__init__(message)
        self.max_error = float(max_error)
        self.limit = float(limit)
        self.per_head = dict(per_head or {})


class QuantizedDense(nn.Module):
    """A ``Dense`` or ``BankedDense`` whose weight is int8 plus an f32
    per-output-channel scale, in torch's layout (``weight_q`` [..., out,
    in], ``weight_scale`` [..., out, 1]). With ``act_scale`` (w8a8, 2-D
    layers only) ``weight_q`` is stored zero-padded to ``_int_mm``'s
    multiples of 8 and the forward runs the int8 product; otherwise the
    forward is the layer's own on the dequantized weight."""

    def __init__(self, layer: nn.Module, q: torch.Tensor, scale: torch.Tensor,
                 act_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.banked = isinstance(layer, BankedDense)
        self.out_features, self.in_features = int(q.shape[-2]), int(q.shape[-1])
        self.bias = layer.bias
        self.register_buffer("weight_scale", scale.to(torch.float32))
        if act_scale is None:
            self.register_buffer("weight_q", q)
            self.register_buffer("act_scale", None)
            self.register_buffer("kernel_scale", None)
        else:
            # [K_pad, N_pad] as the transpose of a contiguous [N_pad, K_pad]
            self.register_buffer("weight_q", pad_weight(q.t()).t())
            self.register_buffer("act_scale", act_scale.to(torch.float32))
            self.register_buffer("kernel_scale", self.weight_scale.t().contiguous())

    @property
    def weight(self) -> torch.Tensor:
        q = self.weight_q
        if self.act_scale is not None:
            q = q[: self.out_features, : self.in_features]
        return dequantize(q, self.weight_scale)

    def forward(self, x, rows=None):
        if self.act_scale is None:
            if self.banked:
                return BankedDense.forward(self, x, rows)
            return dense(x, self.weight, self.bias)
        x_q = quantize_activations(x, self.act_scale)
        y = int8_matmul(x_q, self.weight_q.t())[..., : self.out_features]
        y = y.to(torch.float32) * (self.act_scale * self.kernel_scale)
        if self.bias is not None:
            y = y + self.bias
        return y


@dataclasses.dataclass
class QuantizedInferenceState:
    """An ``InferenceState`` whose dense kernels are int8: ``model`` is a
    copy of the model with its quantized layers replaced by
    ``QuantizedDense``; ``scales`` maps each quantized leaf's flax path to
    its f32 scale in the flax layout (``[1, out]``, ``[B, 1, out]``);
    ``quant`` maps each w8a8 scope to its ``kernel_scale`` and calibrated
    ``act_scale`` (empty in weight-only mode); ``w8a8`` names those
    scopes."""

    model: nn.Module
    scales: Dict[str, torch.Tensor]
    quant: Dict[str, Dict[str, torch.Tensor]]
    step: int = 0
    mode: str = "weight_only"
    w8a8: Tuple[str, ...] = ()

    def weight_nbytes(self) -> int:
        """Resident weight bytes: every parameter and buffer of the
        quantized model (int8 weights count one byte an element)."""
        return weight_nbytes(self.model)


def weight_nbytes(model: nn.Module) -> int:
    """Bytes of a model's parameters and buffers, each once."""
    seen, total = set(), 0
    for t in (*model.parameters(), *model.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# kernel selection
# ---------------------------------------------------------------------------


def _head_output_paths(paths: Sequence[Tuple[str, ...]]) -> set:
    """The highest-indexed ``Dense_k`` kernel under each top-level
    ``heads*`` scope: the per-head output layer, excluded by default."""
    best: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
    for key in paths:
        if len(key) < 3 or key[-1] != "kernel" or not str(key[0]).startswith("heads"):
            continue
        parent = str(key[-2])
        if not parent.startswith("Dense_"):
            continue
        try:
            idx = int(parent.split("_")[-1])
        except ValueError:
            continue
        scope = "/".join(key[:-2])
        if scope not in best or idx > best[scope][0]:
            best[scope] = (idx, key)
    return {key for _, key in best.values()}


def quantizable_leaves(model: nn.Module, exclude: Sequence[str] = ()):
    """The flax leaves (bridge.py ``FlaxLeaf``) the quantizer touches:
    floating ``kernel`` leaves of rank >= 2, minus the per-head output
    layers and any path matching an ``exclude`` substring, in path order."""
    leaves = {tuple(leaf.path.split("/")): leaf for leaf in flax_leaves(model, "params")}
    head_out = _head_output_paths(list(leaves))
    params = dict(model.named_parameters())
    out = []
    for key in sorted(leaves):
        leaf = leaves[key]
        if key[-1] != "kernel" or len(leaf.shape) < 2:
            continue
        if not params[leaf.names[0]].is_floating_point() or key in head_out:
            continue
        if any(pat and pat in leaf.path for pat in exclude):
            continue
        out.append(leaf)
    return out


def _owner(name: str) -> str:
    return name.rsplit(".", 1)[0]


def _replace(model: nn.Module, module_name: str, new: nn.Module) -> None:
    parent_name, _, child = module_name.rpartition(".")
    parent = model.get_submodule(parent_name) if parent_name else model
    setattr(parent, child, new)


# ---------------------------------------------------------------------------
# quantization + calibration
# ---------------------------------------------------------------------------


def _quantize_leaf(model: nn.Module, leaf, act_scale=None):
    """Replace the modules of one flax leaf by ``QuantizedDense``; returns
    the leaf's scale in the flax layout (branch banks stacked)."""
    scales = []
    for name in leaf.names:
        layer = model.get_submodule(_owner(name))
        if not isinstance(layer, (Dense, BankedDense)):
            raise TypeError(f"quantize: {name} belongs to {type(layer).__name__}, "
                            "not a Dense layer")
        w = layer.weight.detach()
        q, scale = quantize_per_channel(w.transpose(-1, -2))  # the flax layout
        _replace(model, _owner(name), QuantizedDense(
            layer, q.transpose(-1, -2).contiguous(), scale.transpose(-1, -2).contiguous(),
            act_scale))
        scales.append(scale)
    return scales[0] if len(scales) == 1 else torch.stack(scales)


def quantize_weights(state, exclude: Sequence[str] = ()) -> QuantizedInferenceState:
    """Weight-only quantization of an ``InferenceState`` (or anything with
    a ``model``): a copy of the model with every selected kernel int8; no
    data needed (``cast_inference_weights(state, "int8")`` lands here).
    Calibration and the gate are the serving layer's (``quantize_state``)."""
    model = copy.deepcopy(state.model).eval()
    scales = {leaf.path: _quantize_leaf(model, leaf)
              for leaf in quantizable_leaves(model, exclude)}
    return QuantizedInferenceState(model=model, scales=scales, quant={},
                                   step=int(getattr(state, "step", 0)), mode="weight_only")


def _calibration_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """scope -> module of every ``Dense`` the calibration may observe: not
    one inside a branch bank (whose JAX counterpart runs under ``vmap``,
    where the probe sees tracers)."""
    banks = [n for n, m in model.named_modules() if getattr(m, "branch_bank", False)]
    out = {}
    for name, m in model.named_modules():
        if type(m) is not Dense or any(name.startswith(b + ".") for b in banks):
            continue
        out[flax_path(f"{name}.weight")[0].rsplit("/", 1)[0]] = m
    return out


def _real_rows(batch, x):
    """The row mask of a layer input ``x`` of ``batch``: its nodes, edges or
    graphs by the leading extent, or None when that names none of them."""
    n = x.shape[0] if x.dim() else -1
    for extent, mask in ((batch.num_nodes, batch.node_mask), (batch.num_edges, batch.edge_mask),
                         (batch.num_graphs, batch.graph_mask)):
        if n == extent and mask is not None:
            return mask
    return None


def calibrate_activations(model: nn.Module, batches: Sequence[Any]
                          ) -> Tuple[Dict[str, float], set]:
    """Forwards over the template batches (placed on the model's device)
    with every observable ``Dense`` input probed (obs/numerics.py) on the
    rows of real nodes, edges or graphs (the probe's mask): per scope
    max-abs statistics -> static activation scales (``max_abs / 127``).
    Returns (scales by scope, the observed scopes): a layer whose forward
    never ran (its weight read directly, as K2 reads ``edge_lin2``) is not
    observed. The JAX package probes every row, the padding's too, where
    the sorted layout's dummy node sums every padding edge: its scales then
    follow the padding, not the traffic."""
    from ..obs.numerics import STAT_FIELDS, ProbeRecord, collecting, probe
    from ..ops.numerics_stats import numerics_stats_plain

    col = STAT_FIELDS.index("max_abs")
    mods = _calibration_modules(model)
    observed, peaks = set(), {}

    current = []

    def hook(scope):
        def pre(module, args):
            observed.add(scope)
            probe(f"quant_calib/{scope}", args[0], _real_rows(current[0], args[0]))
        return pre

    handles = [m.register_forward_pre_hook(hook(s)) for s, m in mods.items()]
    device = next(model.parameters()).device
    try:
        with torch.inference_mode():
            for batch in batches:
                record = ProbeRecord()
                current[:] = [batch.to(device)]
                with collecting(record):
                    model(current[0])
                if not record.entries:
                    continue
                names = [n for n, _, _ in record.entries]
                taps = [x.float() for _, x, _ in record.entries]
                masks = [m for _, _, m in record.entries]
                record.entries = []
                stats, _ = numerics_stats_plain(taps, masks, [], ())
                for name, row in zip(names, stats[:, col].cpu().tolist()):
                    base = name.split("#")[0]
                    if not base.startswith("quant_calib/"):
                        continue  # another tap (a batch norm's) in the same forward
                    scope = base[len("quant_calib/"):]
                    peaks[scope] = max(peaks.get(scope, 0.0), float(row))
    finally:
        for h in handles:
            h.remove()
    scales = {s: (p / INT8_MAX if p > 0.0 else 1.0) for s, p in peaks.items()}
    return scales, observed


def quantize_state(model: nn.Module, state, batches: Sequence[Any], mode: str,
                   exclude: Sequence[str] = ()) -> QuantizedInferenceState:
    """The serving pipeline: weight-only quantize ``state``'s model, then
    (w8a8) calibrate activation scales on ``batches``' real rows and
    promote every calibrated 2-D kernel to int8 x int8 execution. ``model`` is the f32 model the calibration runs
    (the state's own)."""
    if mode not in MODES:
        raise ValueError(f"quantization mode {mode!r} must be one of {MODES}")
    if mode != "w8a8":
        return quantize_weights(state, exclude)
    act_scales, _ = calibrate_activations(model, batches)
    src = copy.deepcopy(state.model).eval()
    scales, quant, w8a8 = {}, {}, []
    for leaf in quantizable_leaves(src, exclude):
        scope = leaf.path.rsplit("/", 1)[0]
        act = None
        if scope in act_scales and len(leaf.shape) == 2:
            act = torch.tensor(act_scales[scope], dtype=torch.float32,
                               device=next(src.parameters()).device)
        scales[leaf.path] = _quantize_leaf(src, leaf, act)
        if act is not None:
            quant[scope] = {"kernel_scale": scales[leaf.path], "act_scale": act}
            w8a8.append(scope)
    return QuantizedInferenceState(model=src, scales=scales, quant=quant,
                                   step=int(getattr(state, "step", 0)), mode="w8a8",
                                   w8a8=tuple(sorted(w8a8)))


# ---------------------------------------------------------------------------
# accuracy gate
# ---------------------------------------------------------------------------


def apply_quantized(state, batch) -> Dict[str, torch.Tensor]:
    """The forward of any inference state (``state.model`` on ``batch``,
    placed on the model's device): the one call the gate and the served
    warm-up share."""
    model = state.model
    device = next(model.parameters()).device
    with torch.inference_mode():
        return model(batch.to(device))


def accuracy_report(fp_state, q_state, batches: Sequence[Any]) -> Dict[str, Any]:
    """Relative max error of quantized against full-precision predictions
    over the template batches, per head and overall, on the rows of real
    graphs and nodes: the rows a client receives (the JAX package counts
    the padding's rows too)."""
    per_head: Dict[str, float] = {}
    for batch in batches:
        fp_out = apply_quantized(fp_state, batch)
        q_out = apply_quantized(q_state, batch)
        for name, ref in fp_out.items():
            got = q_out[name]
            mask = _real_rows(batch, ref)
            if mask is not None:
                mask = mask.to(ref.device)
                ref, got = ref[mask], got[mask]
            ref = ref.float().cpu().numpy()
            got = got.float().cpu().numpy()
            denom = float(np.max(np.abs(ref))) + 1e-8
            err = float(np.max(np.abs(got - ref))) / denom
            per_head[str(name)] = max(per_head.get(str(name), 0.0), err)
    max_error = max(per_head.values()) if per_head else 0.0
    return {
        "max_error": round(max_error, 8),
        "per_head": {k: round(v, 8) for k, v in per_head.items()},
        "batches": len(batches),
    }


def gate_or_raise(fp_state, q_state, batches: Sequence[Any], max_error: float, *,
                  run: str = "", entry: Optional[str] = None) -> Dict[str, Any]:
    """Run the accuracy gate; past ``max_error`` emit ``quant_drift`` and
    raise ``QuantizationDriftError``, so a drifted candidate never reaches
    traffic through warm-up, a watcher swap or a rolling reload."""
    report = dict(accuracy_report(fp_state, q_state, batches))
    report["limit"] = float(max_error)
    report["mode"] = getattr(q_state, "mode", "weight_only")
    if report["max_error"] > float(max_error):
        try:
            from ..obs.events import EV_QUANT_DRIFT, emit

            emit(EV_QUANT_DRIFT, run=run, candidate=entry or "", mode=report["mode"],
                 max_error=report["max_error"], limit=float(max_error),
                 per_head=report["per_head"])
        except Exception:  # noqa: BLE001 -- observability must not mask
            pass
        raise QuantizationDriftError(
            f"quantized predictions drifted {report['max_error']:.4g} "
            f"(relative max error) past Serving.quantization.max_error="
            f"{float(max_error):.4g} on {report['batches']} template "
            f"batch(es); refusing the swap (per head: {report['per_head']})",
            max_error=report["max_error"], limit=float(max_error),
            per_head=report["per_head"],
        )
    return report


def apply_scale_drift(q_state: QuantizedInferenceState,
                      factor: float) -> QuantizedInferenceState:
    """Distort every weight scale by ``factor``: the drifted-candidate
    drill (utils/faultinject.py ``maybe_quant_drift``). Test and chaos
    surface only."""
    model = copy.deepcopy(q_state.model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, QuantizedDense):
                m.weight_scale.mul_(float(factor))
                if m.kernel_scale is not None:
                    m.kernel_scale.mul_(float(factor))
    scales = {k: v * float(factor) for k, v in q_state.scales.items()}
    quant = {s: {"kernel_scale": q["kernel_scale"] * float(factor),
                 "act_scale": q["act_scale"]} for s, q in q_state.quant.items()}
    return dataclasses.replace(q_state, model=model, scales=scales, quant=quant)


# ---------------------------------------------------------------------------
# snapshot artifact
# ---------------------------------------------------------------------------


def snapshot_name(entry: str, mode: str) -> str:
    return f"{entry}.quant-{mode}.npz"


def snapshot_path(log_name: str, entry: str, mode: str, path: str = "./logs") -> str:
    """Beside the checkpoint entry it was quantized from, keyed by entry and
    mode (a w8a8 fleet never loads a weight-only artifact)."""
    return os.path.join(path, log_name, snapshot_name(entry, mode))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_snapshot(q_state: QuantizedInferenceState, report: Dict[str, Any],
                  log_name: str, entry: str, path: str = "./logs") -> str:
    """Write the int8 artifact: one atomic replace and a sha256 sidecar,
    so a reader sees nothing or a verified-complete file (quantization is
    deterministic, so concurrent writers are idempotent)."""
    from ..train.checkpoint import _sha256_path, atomic_write

    payload = {f"model:{k}": _to_numpy(v) for k, v in q_state.model.state_dict().items()}
    payload["__manifest__"] = np.asarray(json.dumps({
        "format_version": SNAPSHOT_FORMAT_VERSION,
        "mode": q_state.mode,
        "w8a8": list(q_state.w8a8),
        "quantized": sorted(q_state.scales),
        "step": int(q_state.step),
        "entry": entry,
        "report": report,
    }))
    buf = io.BytesIO()
    np.savez(buf, **payload)
    blob = buf.getvalue()
    full = snapshot_path(log_name, entry, q_state.mode, path)
    os.makedirs(os.path.dirname(full), exist_ok=True)
    atomic_write(full, blob)
    atomic_write(_sha256_path(full), hashlib.sha256(blob).hexdigest().encode())
    return full


def _structure(model: nn.Module, quantized: Sequence[str], w8a8: Sequence[str]):
    """A copy of ``model`` with the named leaves replaced by placeholder
    ``QuantizedDense`` layers (w8a8 where named), to load a snapshot into."""
    src = copy.deepcopy(model).eval()
    leaves = {leaf.path: leaf for leaf in flax_leaves(src, "params")}
    for path in quantized:
        act = (torch.ones((), device=next(src.parameters()).device)
               if path.rsplit("/", 1)[0] in w8a8 and len(leaves[path].shape) == 2 else None)
        _quantize_leaf(src, leaves[path], act)
    return src


def load_snapshot(model: nn.Module, log_name: str, entry: str, mode: str,
                  path: str = "./logs"
                  ) -> Optional[Tuple[QuantizedInferenceState, Dict[str, Any]]]:
    """Load a pre-quantized artifact into a copy of ``model``'s structure,
    digest-verified: ``(state, its banked gate report)``, or None on any
    trouble (absent, torn, sidecar mismatch, another mode or format, a
    structure that does not fit): the caller quantizes from the checkpoint
    instead."""
    full = snapshot_path(log_name, entry, mode, path)
    if not os.path.exists(full):
        return None
    from ..train.checkpoint import _verified_read

    try:
        blob = _verified_read(full, [])
        if blob is None:
            return None
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            manifest = json.loads(str(z["__manifest__"]))
            if int(manifest.get("format_version", -1)) != SNAPSHOT_FORMAT_VERSION:
                return None
            if manifest.get("mode") != mode or manifest.get("entry") != entry:
                return None
            tensors = {name[len("model:"):]: torch.from_numpy(np.array(z[name]))
                       for name in z.files if name.startswith("model:")}
        w8a8 = tuple(manifest.get("w8a8", ()))
        qmodel = _structure(model, manifest.get("quantized", ()), w8a8)
        qmodel.load_state_dict(tensors, strict=True)
    except (OSError, ValueError, KeyError, RuntimeError, TypeError):
        return None
    leaves = {leaf.path: leaf for leaf in flax_leaves(model, "params")}
    scales, quant = {}, {}
    for p in manifest.get("quantized", ()):
        mods = [qmodel.get_submodule(_owner(n)) for n in leaves[p].names]
        s = [m.weight_scale.transpose(-1, -2) for m in mods]
        scales[p] = s[0] if len(s) == 1 else torch.stack(s)
        scope = p.rsplit("/", 1)[0]
        if scope in w8a8:
            quant[scope] = {"kernel_scale": scales[p], "act_scale": mods[0].act_scale}
    state = QuantizedInferenceState(model=qmodel, scales=scales, quant=quant,
                                    step=int(manifest.get("step", 0)),
                                    mode=str(manifest.get("mode", "weight_only")), w8a8=w8a8)
    return state, dict(manifest.get("report", {}))

