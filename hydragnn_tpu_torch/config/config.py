"""JSON config: data-derived completion of the parts this slice reads.

Counterpart of ``hydragnn_tpu/config/config.py``: same JSON surface, same
derived keys. The sorted-aggregation and flash-attention defaults are keyed
on a CUDA device (where the hand-written kernels run) instead of the JAX
package's TPU check.
"""

from __future__ import annotations

import copy
import json
import os
import sys
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..data.graph import Graph
from ..data.pipeline import VariablesOfInterest
from ..data.transforms import descriptor_edge_dim

# Architecture keys of the radial bases and of DimeNet's and MACE's blocks,
# None when absent
_ARCH_NONE_DEFAULTS = ("radius", "radial_type", "distance_transform", "num_gaussians",
                       "num_filters", "envelope_exponent", "num_after_skip",
                       "num_before_skip", "basis_emb_size", "int_emb_size", "out_emb_size",
                       "num_radial", "num_spherical", "correlation", "max_ell",
                       "node_max_ell")

EQUIVARIANT_MODELS = ("EGNN", "SchNet", "PNAEq", "PAINN", "MACE")
PNA_MODELS = ("PNA", "PNAPlus", "PNAEq")
EDGE_MODELS = ("GAT", "PNA", "PNAPlus", "PNAEq", "PAINN", "GPS", "CGCNN", "SchNet", "EGNN",
               "DimeNet", "MACE")


def degree_histogram(graphs: Sequence[Graph], max_deg: int = 64) -> List[int]:
    """In-degree histogram over all nodes of the dataset, used by the PNA
    degree scalers."""
    hist = np.zeros(max_deg + 1, np.int64)
    top = 0
    for g in graphs:
        deg = np.bincount(g.receivers, minlength=1)
        deg = np.concatenate([deg, np.zeros(g.num_nodes - deg.shape[0], np.int64)])
        h = np.bincount(deg.astype(np.int64), minlength=max_deg + 1)
        if h.shape[0] > hist.shape[0]:
            hist = np.concatenate([hist, np.zeros(h.shape[0] - hist.shape[0], np.int64)])
        hist[: h.shape[0]] += h
        top = max(top, int(deg.max(initial=0)))
    return hist[: top + 1].tolist()


def average_degree(graphs: Sequence[Graph]) -> float:
    """Average in-degree over the graphs (MACE's ``avg_num_neighbors``)."""
    e = sum(g.num_edges for g in graphs)
    n = sum(g.num_nodes for g in graphs)
    return float(e) / max(n, 1)


def voi_from_config(config: Dict[str, Any]) -> VariablesOfInterest:
    """Build the VariablesOfInterest selector from a (completed) config."""
    var = config["NeuralNetwork"]["Variables_of_interest"]
    ds = config.get("Dataset", {})
    return VariablesOfInterest(
        input_node_features=var["input_node_features"],
        output_names=var["output_names"],
        output_types=var["type"],
        output_index=var["output_index"],
        node_feature_dims=ds.get("node_features", {}).get("dim", [1]),
        graph_feature_dims=ds.get("graph_features", {}).get("dim", []),
    )


def measured_max_in_degree(graphs: Sequence[Graph]) -> int:
    top = 1
    for g in graphs:
        if g.num_edges:
            top = max(top, int(np.bincount(np.asarray(g.receivers)).max()))
    return top


def update_config(
    config: Dict[str, Any],
    trainset: Sequence[Graph],
    valset: Sequence[Graph],
    testset: Sequence[Graph],
) -> Dict[str, Any]:
    """Complete a user config from the data; returns a new dict.

    Derived here: ``graph_size_variable``, ``max_nodes_per_graph``, the GPS
    defaults, ``num_pad_buckets``, output dims and types (under
    ``compute_grad_energy`` the dims from ``Variables_of_interest``),
    ``num_nodes``, ``input_dim``, ``pna_deg`` (and ``max_neighbours`` for PNA models),
    MACE's ``avg_num_neighbors``, CGCNN's ``hidden_dim`` (its input width without global
    attention), ``edge_dim`` (the load-time descriptors' columns, else 0 for
    CGCNN), the keys of the radial bases and of DimeNet's and MACE's blocks
    (``_ARCH_NONE_DEFAULTS``: None when absent), the
    measured ``max_in_degree`` (a supplied bound below the data's raises),
    the ``use_sorted_aggregation`` / ``use_fused_edge_kernel`` /
    ``use_flash_attention`` defaults, and the Training section's defaults
    (``num_epoch``, ``Optimizer``, ``EarlyStopping``, ``patience``,
    ``mixed_precision``, ``loss_function_type``, the checkpoint keys
    ``Checkpoint``, ``checkpoint_warmup``, ``checkpoint_retention``, the
    guard's ``non_finite_*`` policy keys, ``warmup_epochs``, ``continue``
    and ``startfrom``, and the compile and memory plane's eight keys,
    ``_complete_compile_plane``), and ``Dataset.bad_sample_policy``.
    ``checkpoint_backend: "orbax"`` raises
    ``NotImplementedError``."""
    config = copy.deepcopy(config)
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"]["Training"]
    var = config["NeuralNetwork"]["Variables_of_interest"]

    sizes = {g.num_nodes for ds in (trainset, valset, testset) for g in ds}
    graph_size_variable = len(sizes) > 1
    arch["graph_size_variable"] = graph_size_variable
    arch["max_nodes_per_graph"] = max(sizes, default=0)

    # GPS defaults
    arch.setdefault("global_attn_engine", None)
    arch.setdefault("global_attn_type", None)
    arch.setdefault("global_attn_heads", 0)
    arch.setdefault("pe_dim", 0)

    training.setdefault("compute_grad_energy", False)
    training.setdefault("num_pad_buckets", 4 if graph_size_variable else 1)

    voi = voi_from_config(config)
    sample = trainset[0]
    output_dim: List[int] = []
    if training["compute_grad_energy"]:
        # energy-force training: the nodal-energy head's dims come from the
        # config, as they cannot be derived from the data
        if "output_dim" not in var:
            raise KeyError(
                "Training.compute_grad_energy requires "
                "Variables_of_interest.output_dim (the nodal-energy head "
                "dims, usually [1]) since they cannot be derived from data"
            )
        output_dim = [int(d) for d in var["output_dim"]]
    else:
        for t, idx in zip(voi.output_types, voi.output_index):
            if t == "graph":
                output_dim.append(int(voi.graph_feature_dims[idx]))
            elif t == "node":
                dim = int(voi.node_feature_dims[idx])
                node_head = arch["output_heads"].get("node", {})
                if isinstance(node_head, list):  # multibranch list form
                    node_head = node_head[0].get("architecture", {}) if node_head else {}
                if not graph_size_variable and node_head.get("type") == "mlp_per_node":
                    dim *= sample.num_nodes
                output_dim.append(dim)
            else:
                raise ValueError(f"output type {t!r} not graph or node")
    arch["output_dim"] = output_dim
    arch["output_type"] = list(voi.output_types)
    arch["num_nodes"] = sample.num_nodes
    var.setdefault("denormalize_output", False)
    arch["input_dim"] = voi.input_dim

    # PNA degree histogram over the training split; the neighbour cap
    # follows the largest degree seen there. MACE normalizes its messages
    # by the training split's average degree
    if arch["mpnn_type"] in PNA_MODELS:
        deg = degree_histogram(trainset)
        arch["pna_deg"] = deg
        arch["max_neighbours"] = len(deg) - 1
    else:
        arch["pna_deg"] = None
    arch["avg_num_neighbors"] = (average_degree(trainset) if arch["mpnn_type"] == "MACE"
                                 else None)

    # sorted aggregation: ON by default where the CUDA kernels run; a static
    # in-degree bound is measured over EVERY split. The CUDA kernels are
    # exact for any degree, but the bound stays part of the config contract
    # shared with the JAX package (whose TPU kernels need it).
    if arch.get("use_sorted_aggregation") is None:
        on = torch.cuda.is_available()
        arch["use_sorted_aggregation"] = on
        if on:
            print(
                "[hydragnn_tpu_torch.config] use_sorted_aggregation "
                "auto-enabled: a CUDA device is present",
                file=sys.stderr,
            )
    if arch.get("use_sorted_aggregation"):
        top = measured_max_in_degree((*trainset, *valset, *testset))
        supplied = arch.get("max_in_degree")
        if supplied and int(supplied) < top:
            raise ValueError(
                f"max_in_degree={supplied} is below the dataset's actual "
                f"max in-degree {top}; remove the key to auto-measure"
            )
        arch["max_in_degree"] = int(supplied or top)
    arch.setdefault("max_in_degree", 0)

    # the fused edge kernel follows sorted aggregation unless set explicitly;
    # fused without sorted could never engage, so it fails loudly
    if arch.get("use_fused_edge_kernel") is None:
        arch["use_fused_edge_kernel"] = bool(arch["use_sorted_aggregation"])
    elif arch["use_fused_edge_kernel"] and not arch["use_sorted_aggregation"]:
        raise ValueError(
            "use_fused_edge_kernel requires use_sorted_aggregation: the "
            "fused edge kernel rides the sorted-receivers contract"
        )

    # GPS flash attention (K4): ON by default where the CUDA kernel runs and
    # GPS attention is configured; an explicit true/false wins. The
    # attention probabilities never exist on the flash route, so flash
    # configs run attention-prob dropout at 0 (models/gps.py).
    if arch.get("use_flash_attention") is None:
        on = bool(arch.get("global_attn_engine")) and torch.cuda.is_available()
        arch["use_flash_attention"] = on
        if on:
            print(
                "[hydragnn_tpu_torch.config] use_flash_attention auto-enabled: "
                "a CUDA device is present; NOTE GPS attention-prob dropout runs "
                "at 0 under this flag (Architecture.dropout still drives the "
                "module-output dropout; set use_flash_attention: false for "
                "reference prob-dropout semantics)",
                file=sys.stderr,
            )

    # CGCNN's conv is dimension-preserving: without global attention the
    # hidden width is the input width
    if arch["mpnn_type"] == "CGCNN" and not arch["global_attn_engine"]:
        arch["hidden_dim"] = arch["input_dim"]
    for key in _ARCH_NONE_DEFAULTS:
        arch.setdefault(key, None)
    # the edge width: the columns the load-time descriptors give
    # (data/transforms.py), else 0 for CGCNN, else the config's
    edge_dim = descriptor_edge_dim(config.get("Dataset", {}))
    if edge_dim:
        assert arch["mpnn_type"] in EDGE_MODELS or arch["global_attn_engine"], (
            "edge features can only be used with edge-aware models")
        arch["edge_dim"] = edge_dim
    elif arch["mpnn_type"] == "CGCNN":
        arch["edge_dim"] = 0

    if arch.get("equivariance"):
        assert arch["mpnn_type"] in EQUIVARIANT_MODELS, (
            "E(3) equivariance can only be ensured for "
            + ", ".join(EQUIVARIANT_MODELS)
        )
    arch.setdefault("equivariance", False)
    arch.setdefault("edge_dim", None)
    arch.setdefault("max_neighbours", None)
    arch.setdefault("activation_function", "relu")
    arch.setdefault("num_conv_layers", 1)
    # the compile and memory plane: the remat wraps (ops/remat.py), the
    # CUDA graphs of the ladder and the retrace sentinel
    # (train/compile_plane.py), and the kernels' tuned table (tune/)
    _complete_compile_plane(training)
    training.setdefault("loss_function_type", "mse")
    training.setdefault("batch_size", 32)
    training.setdefault("num_epoch", 1)
    training.setdefault("perc_train", 0.7)
    training.setdefault("patience", 10)
    training.setdefault("EarlyStopping", False)
    training.setdefault("mixed_precision", False)
    # checkpoints and fault tolerance: best-validation checkpointing after
    # ``checkpoint_warmup`` epochs, the per-epoch chain pruned to its newest
    # ``checkpoint_retention`` files (0 keeps all), the guard's policy for
    # skipped steps, the LR ramp, and resuming a run from its checkpoint
    training.setdefault("Checkpoint", False)
    training.setdefault("checkpoint_warmup", 0)
    training.setdefault("checkpoint_retention", 0)
    if training.get("checkpoint_backend") == "orbax":
        raise NotImplementedError(
            "Training.checkpoint_backend 'orbax' (per-rank sharded checkpoint files) comes "
            "with the port's sharded-checkpoint slice (a later slice, after the multi-GPU "
            "one); the port writes the single file chain of the JAX package's default "
            "'msgpack' backend, rank 0 writing the whole model gathered from every rank"
        )
    training.setdefault("non_finite_policy", "warn_skip")
    if training["non_finite_policy"] not in ("error", "warn_skip", "rollback"):
        raise ValueError(
            f"Training.non_finite_policy {training['non_finite_policy']!r} "
            "must be 'error', 'warn_skip' or 'rollback'"
        )
    training.setdefault("non_finite_rollback_after", 3)
    training.setdefault("non_finite_lr_backoff", 0.5)
    training.setdefault("non_finite_max_rollbacks", 3)
    if training["non_finite_policy"] == "rollback" and not training["Checkpoint"]:
        # rollback restores the last verified checkpoint; without best-val
        # checkpointing a fresh run has none until its end
        print(
            "[hydragnn_tpu_torch.config] non_finite_policy=rollback without "
            "Training.Checkpoint: enable checkpointing or the first "
            "rollback of a fresh run will fail with no checkpoint to "
            "restore",
            file=sys.stderr,
        )
    training.setdefault("warmup_epochs", 0)
    training.setdefault("continue", False)
    training.setdefault("startfrom", None)
    training.setdefault("Optimizer", {"type": "AdamW", "learning_rate": 1e-3})
    training["Optimizer"].setdefault("type", "AdamW")
    training["Optimizer"].setdefault("learning_rate", 1e-3)
    arch.setdefault("task_weights", [1.0] * len(output_dim))
    assert len(arch["task_weights"]) == len(output_dim), (
        f"task_weights {arch['task_weights']} must match number of heads {len(output_dim)}"
    )
    # the sample validator's policy (data/validate.py)
    ds_cfg = config.setdefault("Dataset", {})
    ds_cfg.setdefault("bad_sample_policy", "warn_skip")
    from ..data.validate import POLICIES

    if ds_cfg["bad_sample_policy"] not in POLICIES:
        raise ValueError(f"Dataset.bad_sample_policy {ds_cfg['bad_sample_policy']!r} must be "
                         f"one of {POLICIES}")
    _complete_host_pipeline(training)
    if config.get("Serving"):
        from ..serve.config import ServeConfig

        ServeConfig.from_config(config)
    config.setdefault("Verbosity", {"level": 0})
    config.setdefault("Visualization", {})
    return config


def _complete_host_pipeline(training: Dict[str, Any]) -> None:
    """Defaults and checks of the JAX package's three host-pipeline keys,
    with its ``ValueError``s: ``loader_stall_timeout`` (600.0 s, >= 0; 0
    disables the loader's stall clock, data/pipeline.py),
    ``double_buffer`` (true: device staging 2 batches deep, false: inline
    copies, an int: that depth; ``HYDRAGNN_DEVICE_PREFETCH`` wins,
    train/loop.py) and ``elastic`` (``enabled`` false, ``min_hosts`` 1,
    ``grace_s`` 30.0). ``elastic.enabled: true`` raises
    ``NotImplementedError``: the elastic coordinator is not ported."""
    training.setdefault("loader_stall_timeout", 600.0)
    if float(training["loader_stall_timeout"] or 0) < 0:
        raise ValueError(
            "Training.loader_stall_timeout must be >= 0 (seconds; 0 "
            f"disables), got {training['loader_stall_timeout']!r}")
    training.setdefault("double_buffer", True)
    db = training["double_buffer"]
    if not isinstance(db, (bool, int)) or (not isinstance(db, bool) and int(db) < 0):
        raise ValueError(
            "Training.double_buffer must be true/false or a queue depth "
            f">= 0, got {db!r}")
    el = training.setdefault("elastic", {})
    if not isinstance(el, dict):
        raise ValueError(f"Training.elastic must be a dict of elastic-fleet keys, got {el!r}")
    el.setdefault("enabled", False)
    el.setdefault("min_hosts", 1)
    el.setdefault("grace_s", 30.0)
    if int(el["min_hosts"]) < 1:
        raise ValueError(f"Training.elastic.min_hosts must be >= 1, got {el['min_hosts']!r}")
    if float(el["grace_s"]) < 0:
        raise ValueError(
            f"Training.elastic.grace_s must be >= 0 (seconds), got {el['grace_s']!r}")
    if el["enabled"]:
        raise NotImplementedError(
            "Training.elastic.enabled (the elastic fleet coordinator, train/elastic.py of the "
            "JAX package) comes with the port's robustness slice; the port restarts a shrunk "
            "or grown world from its checkpoint by hand (Training.continue)")


def _complete_compile_plane(training: Dict[str, Any]) -> None:
    """Defaults and checks of the plane's eight Training keys, the JAX
    package's: ``conv_checkpointing`` (False) and ``remat_policy``
    (``full``); ``compile_cache_dir`` (None: ``./logs/<run>/xla_cache``;
    false disables; ``HYDRAGNN_COMPILE_CACHE`` overrides), ``precompile``
    (``background``) and ``retrace_policy`` (``warn``); ``autotune``
    (``cached``), ``autotune_budget`` (32 candidate plans a slot, 0 the
    defaults only) and ``autotune_cache_dir`` (None:
    ``./logs/<run>/tuned_table``; ``HYDRAGNN_TUNE_CACHE`` overrides). A
    value outside its set raises ``ValueError`` naming the key."""
    from ..ops.remat import REMAT_POLICIES
    from ..train.compile_plane import PRECOMPILE_MODES, RETRACE_POLICIES
    from ..tune.runtime import MODES as AUTOTUNE_MODES

    training.setdefault("conv_checkpointing", False)
    for key, default, allowed in (("remat_policy", "full", REMAT_POLICIES),
                                  ("precompile", "background", PRECOMPILE_MODES),
                                  ("retrace_policy", "warn", RETRACE_POLICIES),
                                  ("autotune", "cached", AUTOTUNE_MODES)):
        training.setdefault(key, default)
        if training[key] not in allowed:
            raise ValueError(f"Training.{key} {training[key]!r} must be one of {allowed}")
    training.setdefault("compile_cache_dir", None)
    training.setdefault("autotune_budget", 32)
    if int(training["autotune_budget"] or 0) < 0:
        raise ValueError(
            "Training.autotune_budget must be >= 0 (candidate plans per kernel slot; 0 = "
            f"defaults only), got {training['autotune_budget']!r}")
    training.setdefault("autotune_cache_dir", None)


def get_log_name_config(config: Dict[str, Any]) -> str:
    """Human-readable run name from key hyperparameters."""
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"]["Training"]
    return (
        f"{arch['mpnn_type']}"
        f"-r-{arch.get('radius')}"
        f"-ncl-{arch.get('num_conv_layers')}"
        f"-hd-{arch.get('hidden_dim')}"
        f"-ne-{training.get('num_epoch')}"
        f"-lr-{training.get('Optimizer', {}).get('learning_rate')}"
        f"-bs-{training.get('batch_size')}"
    )


def save_config(config: Dict[str, Any], log_name: str, path: str = "./logs") -> str:
    """Write the completed config to ``<path>/<log name>/config.json``."""
    run_dir = os.path.join(path, log_name)
    os.makedirs(run_dir, exist_ok=True)
    fname = os.path.join(run_dir, "config.json")
    with open(fname, "w") as f:
        json.dump(config, f, indent=2)
    return fname


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
