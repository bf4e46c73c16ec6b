"""Config migration lint: audit a JSON config against the port's config
surface.

Counterpart of ``hydragnn_tpu/config/lint.py`` for ``hydragnn_tpu_torch``.
The JSON surface is the JAX package's (and the reference's), so its
configs run unchanged where the port has the module; this tool says, for
every key, whether the port HANDLES it, whether it is NOT-APPLICABLE on the
H100 (with what applies there instead), a LEGACY key with a direct
replacement, a key of a module NOT-PORTED yet (accepted and ignored, or
raising where turning it on would change the run), or UNKNOWN (likely a
typo: config completion ignores unknown keys).

Usage:
    python -m hydragnn_tpu_torch.config.lint path/to/config.json
    >>> from hydragnn_tpu_torch.config.lint import lint_config
    >>> findings = lint_config(json.load(open("config.json")))
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

# sub-dicts whose members are schema'd elsewhere (heads, optimizer,
# features) or are free-form: the lint stops descending at these paths
_OPAQUE = {
    "NeuralNetwork.Architecture.output_heads",
    "NeuralNetwork.Training.Optimizer",
    "NeuralNetwork.Training.Checkpoint",
    # enabled / min_hosts / grace_s (config/config.py)
    "NeuralNetwork.Training.elastic",
    "Dataset.node_features",
    "Dataset.graph_features",
    "Dataset.path",
    "Dataset.synthetic",
    "Dataset.lennard_jones",
    "Dataset.Descriptors",
    "Mixture.weights",
    "Mixture.branch_loss_weights",
    # the resolved rule table api.py records for a restore
    "Parallel.resolved_rules",
    "Serving.quantization",
}

# exact key paths the port consumes (config/config.py completion,
# models/create.py, api.py, train/loop.py, serve/config.py, obs/telemetry.py,
# parallel/rules.py)
_HANDLED = {
    "Verbosity.level",
    "Dataset.name",
    "Dataset.format",
    "Dataset.path",
    "Dataset.node_features",
    "Dataset.graph_features",
    "Dataset.compositional_stratified_splitting",
    "Dataset.rotational_invariance",
    "Dataset.normalize",
    "Dataset.synthetic",
    "Dataset.lennard_jones",
    "Dataset.bad_sample_policy",
    "Dataset.lappe_cache",
    "Dataset.edge_features",
    "Dataset.Descriptors",
    "Dataset.charge_density_correction",
    "Dataset.mode",
    "NeuralNetwork.Profile",
    "NeuralNetwork.Profile.enable",
    "NeuralNetwork.Profile.target_epoch",
    "NeuralNetwork.Architecture.mpnn_type",
    "NeuralNetwork.Architecture.activation_function",
    "NeuralNetwork.Architecture.equivariance",
    "NeuralNetwork.Architecture.radius",
    "NeuralNetwork.Architecture.max_neighbours",
    "NeuralNetwork.Architecture.periodic_boundary_conditions",
    "NeuralNetwork.Architecture.hidden_dim",
    "NeuralNetwork.Architecture.num_conv_layers",
    "NeuralNetwork.Architecture.output_heads",
    "NeuralNetwork.Architecture.task_weights",
    "NeuralNetwork.Architecture.output_dim",
    "NeuralNetwork.Architecture.output_type",
    "NeuralNetwork.Architecture.input_dim",
    "NeuralNetwork.Architecture.edge_dim",
    "NeuralNetwork.Architecture.edge_features",
    "NeuralNetwork.Architecture.num_nodes",
    "NeuralNetwork.Architecture.pna_deg",
    "NeuralNetwork.Architecture.num_gaussians",
    "NeuralNetwork.Architecture.num_filters",
    "NeuralNetwork.Architecture.num_radial",
    "NeuralNetwork.Architecture.num_spherical",
    "NeuralNetwork.Architecture.envelope_exponent",
    "NeuralNetwork.Architecture.radial_type",
    "NeuralNetwork.Architecture.distance_transform",
    "NeuralNetwork.Architecture.basis_emb_size",
    "NeuralNetwork.Architecture.int_emb_size",
    "NeuralNetwork.Architecture.out_emb_size",
    "NeuralNetwork.Architecture.num_before_skip",
    "NeuralNetwork.Architecture.num_after_skip",
    "NeuralNetwork.Architecture.max_ell",
    "NeuralNetwork.Architecture.node_max_ell",
    "NeuralNetwork.Architecture.correlation",
    "NeuralNetwork.Architecture.avg_num_neighbors",
    "NeuralNetwork.Architecture.global_attn_engine",
    "NeuralNetwork.Architecture.global_attn_type",
    "NeuralNetwork.Architecture.global_attn_heads",
    "NeuralNetwork.Architecture.pe_dim",
    "NeuralNetwork.Architecture.max_nodes_per_graph",
    "NeuralNetwork.Architecture.freeze_conv_layers",
    "NeuralNetwork.Architecture.initial_bias",
    "NeuralNetwork.Architecture.use_sorted_aggregation",
    "NeuralNetwork.Architecture.max_in_degree",
    "NeuralNetwork.Architecture.use_fused_edge_kernel",
    "NeuralNetwork.Architecture.use_flash_attention",
    "NeuralNetwork.Architecture.branch_loss_weights",
    "NeuralNetwork.Architecture.branch_loss_metrics",
    "NeuralNetwork.Architecture.dropout",
    "NeuralNetwork.Architecture.decoder_mirror_init",
    "NeuralNetwork.Architecture.decoder_recovery_slope",
    "NeuralNetwork.Variables_of_interest.input_node_features",
    "NeuralNetwork.Variables_of_interest.output_names",
    "NeuralNetwork.Variables_of_interest.output_index",
    "NeuralNetwork.Variables_of_interest.output_dim",
    "NeuralNetwork.Variables_of_interest.type",
    "NeuralNetwork.Variables_of_interest.denormalize_output",
    "NeuralNetwork.Variables_of_interest.graph_feature_names",
    "NeuralNetwork.Variables_of_interest.graph_feature_dims",
    "NeuralNetwork.Variables_of_interest.node_feature_names",
    "NeuralNetwork.Variables_of_interest.node_feature_dims",
    "NeuralNetwork.Training.num_epoch",
    "NeuralNetwork.Training.batch_size",
    "NeuralNetwork.Training.perc_train",
    "NeuralNetwork.Training.loss_function_type",
    "NeuralNetwork.Training.EarlyStopping",
    "NeuralNetwork.Training.patience",
    "NeuralNetwork.Training.seed",
    "NeuralNetwork.Training.continue",
    "NeuralNetwork.Training.startfrom",
    "NeuralNetwork.Training.Checkpoint",
    "NeuralNetwork.Training.checkpoint_warmup",
    "NeuralNetwork.Training.checkpoint_retention",
    "NeuralNetwork.Training.non_finite_policy",
    "NeuralNetwork.Training.non_finite_rollback_after",
    "NeuralNetwork.Training.non_finite_lr_backoff",
    "NeuralNetwork.Training.non_finite_max_rollbacks",
    "NeuralNetwork.Training.loader_stall_timeout",
    "NeuralNetwork.Training.compile_cache_dir",
    "NeuralNetwork.Training.precompile",
    "NeuralNetwork.Training.retrace_policy",
    "NeuralNetwork.Training.autotune",
    "NeuralNetwork.Training.autotune_budget",
    "NeuralNetwork.Training.autotune_cache_dir",
    "NeuralNetwork.Training.compute_grad_energy",
    "NeuralNetwork.Training.conv_checkpointing",
    "NeuralNetwork.Training.remat_policy",
    "NeuralNetwork.Training.Optimizer",
    "NeuralNetwork.Training.mixed_precision",
    "NeuralNetwork.Training.pack_batches",
    "NeuralNetwork.Training.num_pad_buckets",
    "NeuralNetwork.Training.size_bucketed_batching",
    "NeuralNetwork.Training.branch_parallel",
    "NeuralNetwork.Training.double_buffer",
    "NeuralNetwork.Training.warmup_epochs",
    "NeuralNetwork.Training.return_best",
    "NeuralNetwork.Training.oversampling",
    "NeuralNetwork.Training.num_samples",
    "NeuralNetwork.Training.balance_branch_sampling",
    "Serving.max_queue_requests",
    "Serving.micro_batch_graphs",
    "Serving.batch_window_s",
    "Serving.default_deadline_s",
    "Serving.slo_p99_s",
    "Serving.expected_latency_per_graph_s",
    "Serving.step_timeout_s",
    "Serving.retrace_policy",
    "Serving.drain_timeout_s",
    "Serving.http_port",
    "Serving.http_host",
    # hot reload, reduced-precision weights and the fleet (serve/)
    "Serving.hot_reload",
    "Serving.reload_poll_s",
    "Serving.weights_dtype",
    "Serving.quantization",
    "Serving.drain_grace_s",
    "Serving.fleet_replicas",
    "Serving.fleet_restart_backoff_s",
    "Serving.fleet_restart_backoff_max_s",
    "Serving.fleet_flap_window_s",
    "Serving.fleet_flap_max_restarts",
    "Serving.fleet_ready_floor",
    "Serving.router_timeout_s",
    "Serving.router_retries",
    "Serving.router_backoff_s",
    "Serving.router_hedge_factor",
    "Serving.router_hedge_min_s",
    "Serving.breaker_failures",
    "Serving.breaker_cooldown_s",
    "Serving.prediction_cache",
    "Serving.reload_error_spike",
    "Serving.reload_probe_requests",
    "Telemetry.enabled",
    "Telemetry.interval_steps",
    "Telemetry.http_port",
    "Telemetry.http_host",
    "Telemetry.mfu",
    "Telemetry.jsonl",
    "Telemetry.profile_trigger",
    "Telemetry.profile_steps",
    "Telemetry.trace",
    "Telemetry.trace_sample",
    "Telemetry.trace_interval_steps",
    "Telemetry.flight_recorder",
    "Telemetry.numerics",
    "Telemetry.fleet",
    "Telemetry.fleet_collector",
    "Telemetry.fleet_collector_port",
    "Telemetry.fleet_collector_host",
    "Telemetry.fleet_straggler_factor",
    "Telemetry.fleet_max_step_lag",
    "Telemetry.fleet_stale_after_s",
    "Telemetry.fleet_collective_budget",
    "Telemetry.fleet_sharding_audit_bytes",
    # the sharding rule table (parallel/rules.py)
    "Parallel.rules",
    "Parallel.min_size",
    "Parallel.model_size",
    "Parallel.routed",
    "Parallel.name",
    "Parallel.resolved_rules",
}
# keys of modules the port has not ported yet: accepted and ignored, or
# (where turning them on would change the run) raising at config completion
_NOT_PORTED = {
    "NeuralNetwork.Training.checkpoint_backend": (
        "'msgpack' (the default single-file chain) is handled; 'orbax' (per-rank sharded "
        "files) raises NotImplementedError until the sharded-checkpoint slice"
    ),
    "NeuralNetwork.Training.elastic": (
        "defaulted and checked as in the JAX package; enabled: true raises "
        "NotImplementedError (train/elastic.py is not ported)"
    ),
    "NeuralNetwork.Training.walltime_minutes": "utils/walltime.py is not ported: ignored",
    "NeuralNetwork.Training.CheckRemainingTime": "utils/walltime.py is not ported: ignored",
    "Visualization.create_plots": "postprocess/ is not ported: no plots are made",
}
_NOT_PORTED.update({f"Mixture.{k}": "the mixture plane (mix/) is not ported: a Mixture "
                    "section raises NotImplementedError in prepare_data"
                    for k in ("temperature", "weights", "draws_per_epoch", "balance",
                              "branch_loss_weights", "drift_ema_decay", "drift_threshold",
                              "demote_after", "seed")})
# reference keys the port does not consume, with what applies on the H100
_NOT_APPLICABLE = {
    "NeuralNetwork.Architecture.SyncBatchNorm": (
        "no DDP wrapper to convert: batch-norm statistics are the masked batch's, "
        "computed inside the step (models/layers.py MaskedBatchNorm); the distributed "
        "step (parallel/engine.py) weights every rank's running statistics by its real "
        "graphs over torch.distributed"
    ),
}

# a few reference configs predate the NeuralNetwork nesting and put
# Architecture at the top level: one uniform rename
_LEGACY_TOPLEVEL_ARCH = (
    "legacy top-level 'Architecture' section (pre-NeuralNetwork layout) — nest the keys "
    "under NeuralNetwork.Architecture ('periodic' becomes 'periodic_boundary_conditions'; "
    "'predicted_value_option' is superseded by Variables_of_interest.output_index/type)"
)

# legacy or renamed keys -> what to use
_LEGACY = {
    "NeuralNetwork.Training.early_stopping": (
        "use 'EarlyStopping' (capitalized, the reference's current key)"
    ),
    "NeuralNetwork.Training.epoch_start": (
        "resume is 'Training.continue: 1' (+ optional 'startfrom'); the epoch counter "
        "restores from the checkpoint"
    ),
    "NeuralNetwork.Architecture.predicted_value_option": (
        "superseded by Variables_of_interest.output_index/type"
    ),
    "Visualization.plot_init_solution": (
        "plot families are chosen by the postprocess API; 'create_plots' gates them all"
    ),
    "Visualization.plot_hist_solution": (
        "plot families are chosen by the postprocess API; 'create_plots' gates them all"
    ),
}

# the top-level sections ("Serving", "Telemetry", "Mixture" and "Parallel"
# are the framework's own)
_TOPLEVEL_SECTIONS = (
    "Verbosity", "Dataset", "NeuralNetwork", "Visualization", "Serving",
    "Telemetry", "Mixture", "Parallel",
)

STATUSES = ("unknown", "not-ported", "legacy", "not-applicable", "handled")


@dataclasses.dataclass(frozen=True)
class Finding:
    status: str  # one of STATUSES
    path: str
    message: str = ""


def _walk(d: Dict[str, Any], prefix: str = "") -> List[str]:
    # never descends into an _OPAQUE subtree
    out = []
    for k, v in d.items():
        p = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        out.append(p)
        if isinstance(v, dict) and p not in _OPAQUE:
            out.extend(_walk(v, p))
    return out


def lint_config(config: Dict[str, Any]) -> List[Finding]:
    """One finding per key path of ``config``."""
    findings: List[Finding] = []
    for path in _walk(config):
        if path in _NOT_APPLICABLE:
            findings.append(Finding("not-applicable", path, _NOT_APPLICABLE[path]))
        elif path == "Architecture" or path.startswith("Architecture."):
            findings.append(Finding("legacy", path, _LEGACY_TOPLEVEL_ARCH))
        elif path in _LEGACY:
            findings.append(Finding("legacy", path, _LEGACY[path]))
        elif path in _NOT_PORTED:
            findings.append(Finding("not-ported", path, _NOT_PORTED[path]))
        elif path in _HANDLED or path in _TOPLEVEL_SECTIONS or path in (
                "NeuralNetwork.Architecture", "NeuralNetwork.Variables_of_interest",
                "NeuralNetwork.Training", "NeuralNetwork.Profile"):
            findings.append(Finding("handled", path))
        else:
            findings.append(Finding(
                "unknown", path,
                "not consumed by hydragnn_tpu_torch (config completion ignores unknown keys, "
                "as the reference does) — check for a typo"))
    return findings


def format_report(findings: List[Finding]) -> str:
    order = {s: i for i, s in enumerate(STATUSES)}
    lines = []
    counts: Dict[str, int] = {}
    for f in sorted(findings, key=lambda f: (order[f.status], f.path)):
        counts[f.status] = counts.get(f.status, 0) + 1
        if f.status == "handled":
            continue
        lines.append(f"[{f.status}] {f.path}: {f.message}")
    lines.append("summary: " + ", ".join(f"{counts.get(s, 0)} {s}" for s in STATUSES))
    return "\n".join(lines)


def main(argv=None) -> int:
    """Exit codes: 0 clean, 1 unknown keys found, 2 could not lint."""
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m hydragnn_tpu_torch.config.lint config.json")
        return 2
    try:
        with open(argv[0]) as fh:
            config = json.load(fh)
    except OSError as e:
        print(f"hydragnn_tpu_torch.config.lint: cannot read {argv[0]}: {e}")
        return 2
    except json.JSONDecodeError as e:
        print(f"hydragnn_tpu_torch.config.lint: {argv[0]} is not valid JSON: {e}")
        return 2
    if not isinstance(config, dict):
        print(f"hydragnn_tpu_torch.config.lint: {argv[0]} is a JSON "
              f"{type(config).__name__}, expected an object")
        return 2
    findings = lint_config(config)
    print(format_report(findings))
    return 1 if any(f.status == "unknown" for f in findings) else 0


if __name__ == "__main__":
    raise SystemExit(main())
