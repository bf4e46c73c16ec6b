"""Model factory: completed JSON config -> model on a device.

Counterpart of ``hydragnn_tpu/models/create.py``. Twelve convs are
registered (CGCNN, DimeNet, EGNN, GAT, GIN, MFC, PAINN, PNA, PNAEq, PNAPlus,
SAGE, SchNet) into ``HydraModel``, with GPS global attention ("multihead",
"performer", or "ring" for one spanning graph) around any of them; MACE is
its own model class (``MACEModel``: per-layer readouts summed), as in the
JAX package. Every node-head type ("mlp", "mlp_per_node", "conv"), the
variance heads of ``GaussianNLLLoss`` and the multibranch loss weights
(``Architecture.branch_loss_weights`` / ``branch_loss_metrics``) are read.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..device import DeviceLike, resolve_device
from .base import conv_needs_triplets  # noqa: F401 -- read with the registry filled
from .base import GraphHeadConfig, HydraModel, ModelConfig, NodeHeadConfig
from .layers import reset_parameters

# import model files for their registry side effects
from . import cgcnn as _cgcnn  # noqa: F401
from . import dimenet as _dimenet  # noqa: F401
from . import egnn as _egnn  # noqa: F401
from . import gat as _gat  # noqa: F401
from . import gin as _gin  # noqa: F401
from . import mfc as _mfc  # noqa: F401
from . import painn as _painn  # noqa: F401
from . import pna as _pna  # noqa: F401
from . import pna_eq as _pna_eq  # noqa: F401
from . import pna_plus as _pna_plus  # noqa: F401
from . import sage as _sage  # noqa: F401
from . import schnet as _schnet  # noqa: F401


def normalize_output_heads(heads: Dict[str, Any]) -> Dict[str, List[Dict[str, Any]]]:
    """Upgrade single-branch head configs to the multibranch list form."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for key, val in heads.items():
        if isinstance(val, list):
            out[key] = val
        else:
            out[key] = [{"type": "branch-0", "architecture": dict(val)}]
    return out


def model_config_from(config: Dict[str, Any]) -> ModelConfig:
    """Build the frozen ModelConfig from a completed config dict (after
    ``hydragnn_tpu_torch.config.update_config``)."""
    nn_cfg = config["NeuralNetwork"]
    arch = nn_cfg["Architecture"]
    training = nn_cfg["Training"]
    var = nn_cfg["Variables_of_interest"]
    loss_type = training.get("loss_function_type", "mse")

    heads = normalize_output_heads(arch["output_heads"])
    graph_head = node_head = None
    num_branches = 1
    if "graph" in heads:
        num_branches = len(heads["graph"])
        a = heads["graph"][0]["architecture"]
        graph_head = GraphHeadConfig(
            num_sharedlayers=a.get("num_sharedlayers", 2),
            dim_sharedlayers=a.get("dim_sharedlayers", 10),
            num_headlayers=a.get("num_headlayers", 2),
            dim_headlayers=tuple(a.get("dim_headlayers", (10, 10))),
        )
    if "node" in heads:
        a = heads["node"][0]["architecture"]
        node_head = NodeHeadConfig(
            nn_type=a.get("type", "mlp"),
            num_headlayers=a.get("num_headlayers", 2),
            dim_headlayers=tuple(a.get("dim_headlayers", (10, 10))),
        )
    return ModelConfig(
        mpnn_type=arch["mpnn_type"],
        input_dim=int(arch["input_dim"]),
        hidden_dim=int(arch["hidden_dim"]),
        num_conv_layers=int(arch["num_conv_layers"]),
        output_names=tuple(var["output_names"]),
        output_dim=tuple(int(d) for d in arch["output_dim"]),
        output_type=tuple(arch["output_type"]),
        task_weights=tuple(float(w) for w in arch["task_weights"]),
        graph_head=graph_head,
        node_head=node_head,
        num_branches=num_branches,
        branch_loss_weights=(tuple(float(w) for w in arch["branch_loss_weights"])
                             if arch.get("branch_loss_weights") else None),
        branch_loss_metrics=bool(arch.get("branch_loss_metrics", False)),
        activation=arch.get("activation_function", "relu"),
        loss_function_type=loss_type,
        num_nodes=arch.get("num_nodes"),
        var_output=loss_type == "GaussianNLLLoss",
        edge_dim=int(arch.get("edge_dim") or 0),
        radius=None if arch.get("radius") is None else float(arch["radius"]),
        num_gaussians=arch.get("num_gaussians"),
        num_filters=arch.get("num_filters"),
        num_radial=arch.get("num_radial"),
        num_spherical=arch.get("num_spherical"),
        envelope_exponent=arch.get("envelope_exponent"),
        radial_type=arch.get("radial_type"),
        distance_transform=arch.get("distance_transform"),
        basis_emb_size=arch.get("basis_emb_size"),
        int_emb_size=arch.get("int_emb_size"),
        out_emb_size=arch.get("out_emb_size"),
        num_before_skip=arch.get("num_before_skip"),
        num_after_skip=arch.get("num_after_skip"),
        avg_num_neighbors=arch.get("avg_num_neighbors"),
        max_ell=arch.get("max_ell"),
        node_max_ell=arch.get("node_max_ell"),
        correlation=arch.get("correlation"),
        max_neighbours=arch.get("max_neighbours"),
        global_attn_engine=arch.get("global_attn_engine") or "",
        global_attn_type=arch.get("global_attn_type") or "",
        global_attn_heads=int(arch.get("global_attn_heads") or 0),
        pe_dim=int(arch.get("pe_dim") or 0),
        max_nodes_per_graph=int(arch.get("max_nodes_per_graph") or 0),
        use_flash_attention=bool(arch.get("use_flash_attention", False)),
        dropout=float(0.25 if arch.get("dropout") is None else arch["dropout"]),
        pna_deg=tuple(arch.get("pna_deg") or ()),
        equivariance=bool(arch.get("equivariance", False)),
        sorted_aggregation=bool(arch.get("use_sorted_aggregation", False)),
        max_in_degree=int(arch.get("max_in_degree") or 0),
        fused_edge_kernel=bool(arch.get("use_fused_edge_kernel", False)),
        decoder_mirror_init=bool(
            True if arch.get("decoder_mirror_init") is None
            else arch["decoder_mirror_init"]
        ),
        decoder_recovery_slope=float(
            0.1 if arch.get("decoder_recovery_slope") is None
            else arch["decoder_recovery_slope"]
        ),
        conv_checkpointing=bool(training.get("conv_checkpointing", False)),
        remat_policy=str(training.get("remat_policy", "full")),
    )


def create_model(config: Dict[str, Any], device: DeviceLike = None,
                 seed: int = 0) -> torch.nn.Module:
    """Completed config -> ``HydraModel`` (``MACEModel`` for MACE, with the
    JAX package's checks) in eval mode on ``device`` (the current CUDA
    device when None; raises when there is none), its weights drawn from
    ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    cfg = model_config_from(config)
    if cfg.mpnn_type == "MACE":
        from .mace import MACEModel

        assert cfg.radius is not None, "MACE requires radius"
        assert cfg.num_radial is not None, "MACE requires num_radial"
        assert (cfg.max_ell or 0) >= 1, "MACE requires max_ell >= 1"
        assert (cfg.node_max_ell or 0) >= 1, "MACE requires node_max_ell >= 1"
        assert not cfg.use_global_attn, "GPS global attention is not supported with MACE"
        model = MACEModel(cfg)
    else:
        model = HydraModel(cfg)
    reset_parameters(model, torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()
