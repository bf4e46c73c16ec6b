"""Multi-headed encoder/decoder base model.

Counterpart of ``hydragnn_tpu/models/base.py``: a conv stack over padded
``GraphBatch``es (each conv followed by masked batch norm and the
activation), masked mean pooling, and branch-bank decoders whose
parameters keep a leading ``[num_branches]`` axis, decoded densely for every
branch and selected per graph by ``dataset_id``. Node heads are a shared MLP
(``mlp``), one MLP per node position in its graph (``mlp_per_node``), or a
chain of the model's own conv type (``conv``), one chain per branch; under
``var_output`` every head is twice as wide and its second half, squared,
is the ``<name>__var`` output. With GPS global attention
(``global_attn_engine``) the inputs are embedded with the Laplacian
positional encodings first (``pos_emb``, ``node_emb``/``node_lin``,
``rel_pos_emb``) and every conv is wrapped in a ``GPSConv``.

Every conv layer implements ``(inv, equiv, batch) -> (inv, equiv)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..obs.numerics import probe
from ..ops.segment import masked_global_mean_pool
from .gps import GPSConv
from .layers import MLP, Dense, MaskedBatchNorm, get_activation, name_probes


@dataclasses.dataclass(frozen=True)
class GraphHeadConfig:
    num_sharedlayers: int = 2
    dim_sharedlayers: int = 10
    num_headlayers: int = 2
    dim_headlayers: Tuple[int, ...] = (10, 10)


@dataclasses.dataclass(frozen=True)
class NodeHeadConfig:
    nn_type: str = "mlp"  # mlp | mlp_per_node | conv
    num_headlayers: int = 2
    dim_headlayers: Tuple[int, ...] = (10, 10)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Frozen hyperparameter record; field names follow the JAX package's
    ``ModelConfig`` (and so the config's Architecture keys)."""

    mpnn_type: str
    input_dim: int
    hidden_dim: int
    num_conv_layers: int
    output_names: Tuple[str, ...]
    output_dim: Tuple[int, ...]
    output_type: Tuple[str, ...]
    task_weights: Tuple[float, ...]
    graph_head: Optional[GraphHeadConfig] = None
    node_head: Optional[NodeHeadConfig] = None
    num_branches: int = 1
    # static per-branch loss weights (every graph's loss weighted by its
    # branch's entry) and the per-branch loss scalars (``branch<i>`` tasks)
    branch_loss_weights: Optional[Tuple[float, ...]] = None
    branch_loss_metrics: bool = False
    activation: str = "relu"
    loss_function_type: str = "mse"
    edge_dim: int = 0
    equivariance: bool = False
    # nodes per graph of the first training graph (``mlp_per_node``)
    num_nodes: Optional[int] = None
    # variance heads (``GaussianNLLLoss``)
    var_output: bool = False
    # geometry and radial bases (None: the conv's own default)
    radius: Optional[float] = None
    num_gaussians: Optional[int] = None
    num_filters: Optional[int] = None
    num_radial: Optional[int] = None
    num_spherical: Optional[int] = None
    envelope_exponent: Optional[int] = None
    radial_type: Optional[str] = None
    distance_transform: Optional[str] = None
    # DimeNet's block sizes
    basis_emb_size: Optional[int] = None
    int_emb_size: Optional[int] = None
    out_emb_size: Optional[int] = None
    num_before_skip: Optional[int] = None
    num_after_skip: Optional[int] = None
    # MACE
    avg_num_neighbors: Optional[float] = None
    max_ell: Optional[int] = None
    node_max_ell: Optional[int] = None
    correlation: Optional[int] = None
    # MFC's degree cap
    max_neighbours: Optional[int] = None
    # GPS global attention
    global_attn_engine: str = ""
    global_attn_type: str = ""
    global_attn_heads: int = 0
    pe_dim: int = 0
    # static bound on nodes per graph (data-derived): lets GPS attention run
    # per graph ([G, Nmax] layout, or K4) instead of over the flat [N, N]
    max_nodes_per_graph: int = 0
    # GPS attention through the segment-masked flash kernel (K4)
    use_flash_attention: bool = False
    dropout: float = 0.25
    # PNA in-degree histogram of the training split (degree scalers)
    pna_deg: Tuple[int, ...] = ()
    # receiver-sorted edges + static in-degree bound route the aggregation
    # through K1 (ops/segment.py); fused_edge_kernel routes the single-
    # consumer EGNN edge path through K2
    sorted_aggregation: bool = False
    max_in_degree: int = 0
    fused_edge_kernel: bool = False
    decoder_mirror_init: bool = True
    decoder_recovery_slope: float = 0.1
    # the remat wraps of a train step (ops/remat.py): the whole loss
    # checkpointed under conv_checkpointing, with remat_policy's save rule
    # there and at the kernel call sites
    conv_checkpointing: bool = False
    remat_policy: str = "full"

    @property
    def normalized_task_weights(self) -> Tuple[float, ...]:
        s = sum(abs(w) for w in self.task_weights)
        return tuple(w / s for w in self.task_weights)

    @property
    def use_edge_attr(self) -> bool:
        return self.edge_dim > 0

    @property
    def use_global_attn(self) -> bool:
        return bool(self.global_attn_engine)


# conv registry: mpnn_type -> (is_edge_model, ctor(cfg, in_dim, out_dim, last_layer))
_CONV_REGISTRY: Dict[str, Tuple[bool, Callable]] = {}
# the convs whose batches carry the triplet channel (PadSpec.n_triplets)
_TRIPLET_CONVS = set()


def register_conv(name: str, is_edge_model: bool = False, needs_triplets: bool = False):
    def deco(ctor):
        _CONV_REGISTRY[name] = (is_edge_model, ctor)
        if needs_triplets:
            _TRIPLET_CONVS.add(name)
        return ctor

    return deco


def conv_needs_triplets(name: str) -> bool:
    """Whether the conv ``name`` reads the batch's triplet channel."""
    return name in _TRIPLET_CONVS


def get_conv_ctor(name: str):
    try:
        return _CONV_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown mpnn_type {name!r}; registered: {sorted(_CONV_REGISTRY)}"
        )


class MLPNode(nn.Module):
    """Per-node MLP head: ``mlp`` shares one MLP (its layers under
    ``MLP_0``) across all nodes; ``mlp_per_node`` keeps one MLP per node
    position in its graph (``VmapMLP_0``: every layer a bank of
    ``[num_branches, num_nodes, ...]`` weights), a node at position ``p``
    decoded by MLP ``p % num_nodes``, as in the flax tree."""

    def __init__(self, in_dim: int, output_dim: int, hidden_dims, activation: str,
                 mirror_init: bool, recovery_slope: float, num_branches: int,
                 nn_type: str = "mlp", num_nodes: int = 0):
        super().__init__()
        self.nn_type = nn_type
        feats = tuple(hidden_dims) + (output_dim,)
        if nn_type == "mlp":
            self.MLP_0 = MLP(in_dim, feats, activation, mirror_init=mirror_init,
                             recovery_slope=recovery_slope, num_branches=num_branches)
            return
        if not num_nodes or num_nodes <= 0:
            raise ValueError("mlp_per_node requires a fixed graph size (num_nodes)")
        self.num_nodes = int(num_nodes)
        self.VmapMLP_0 = MLP(in_dim, feats, activation, mirror_init=mirror_init,
                             recovery_slope=recovery_slope,
                             num_branches=(num_branches, self.num_nodes))

    def forward(self, x, batch):
        if self.nn_type == "mlp":
            return self.MLP_0(x)
        pos = node_position_in_graph(batch) % self.num_nodes
        return self.VmapMLP_0(x, rows=pos)


def node_position_in_graph(batch) -> torch.Tensor:
    """Index of each node within its own graph (0 .. n_g - 1): its row less
    the first row of its graph (a padding node counts in the padding
    graph)."""
    n = batch.num_nodes
    idx = torch.arange(n, device=batch.node_graph.device)
    start = torch.full((batch.num_graphs,), n, dtype=idx.dtype, device=idx.device)
    start = start.scatter_reduce(0, batch.node_graph.long(), idx, reduce="amin")
    return idx - start[batch.node_graph.long()]


class NodeConvHead(nn.Module):
    """One branch's conv-chain node head: a conv of the model's own type per
    width of ``dim_headlayers`` and one to ``out_dim`` (the last in its
    final form), each followed by masked batch norm and the activation.
    Modules are named as flax names them: ``<conv class>_<i>`` and
    ``MaskedBatchNorm_<i>``."""

    def __init__(self, cfg: "ModelConfig", out_dim: int):
        super().__init__()
        _, ctor = get_conv_ctor(cfg.mpnn_type)
        self.act = get_activation(cfg.activation)
        nh = cfg.node_head or NodeHeadConfig()
        dims = tuple(nh.dim_headlayers) + (out_dim,)
        in_d = vec_d = cfg.hidden_dim
        self.names = []
        for i, hd in enumerate(dims):
            conv = ctor(cfg, in_d, hd, i == len(dims) - 1)
            if hasattr(conv, "vectors_in"):  # the vectors arrive at the last width
                conv.vectors_in(vec_d)
                vec_d = hd
            # a conv wider than asked (GAT's concatenated heads) says so
            in_d = getattr(conv, "out_width", hd)
            name = f"{type(conv).__name__}_{i}"
            self.add_module(name, conv)
            self.add_module(f"MaskedBatchNorm_{i}", MaskedBatchNorm(in_d))
            self.names.append(name)

    def forward(self, x, equiv, batch):
        inv, eq = x, equiv
        for i, name in enumerate(self.names):
            inv, eq = getattr(self, name)(inv, eq, batch)
            bn = getattr(self, f"MaskedBatchNorm_{i}")
            inv = self.act(bn(inv, batch.node_mask, train=self.training))
        return inv


class BranchBank(nn.Module):
    """A module built once per branch (``branches.<b>``), each with its own
    parameters and batch-norm statistics: the flax ``nn.vmap`` branch bank
    of a module whose layers cannot be banked as one tensor (a conv
    chain). ``forward`` stacks the branches' outputs to ``[B, ...]``.
    ``bridge.py`` maps the flax tree's ``[B, ...]`` leaves onto the
    branches (``branch_bank``)."""

    branch_bank = True

    def __init__(self, build, num_branches: int):
        super().__init__()
        self.branches = nn.ModuleList(build() for _ in range(num_branches))

    def forward(self, *args):
        return torch.stack([m(*args) for m in self.branches])


class HydraModel(nn.Module):
    """Encoder (conv stack) + multi-head, multi-branch decoders.

    ``forward(batch)`` returns ``{head_name: predictions}``: graph heads
    [G, d], node heads [N, d]; padding rows are garbage, reduce with the
    batch masks."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.is_edge_model, ctor = get_conv_ctor(cfg.mpnn_type)
        in_dim = cfg.hidden_dim if cfg.use_global_attn else cfg.input_dim
        convs, widths = [], []
        for i in range(cfg.num_conv_layers):
            # under GPS every conv output must match the residual's width, so
            # every conv takes its final-layer form
            final_form = cfg.use_global_attn or i == cfg.num_conv_layers - 1
            mpnn = ctor(cfg, in_dim, cfg.hidden_dim, final_form)
            # a conv wider than hidden_dim (GAT's concatenated heads) says
            # so: the next conv and this layer's batch norm take its width,
            # as flax infers it
            in_dim = getattr(mpnn, "out_width", cfg.hidden_dim)
            widths.append(in_dim)
            if cfg.use_global_attn:
                mpnn = GPSConv(
                    cfg.hidden_dim, mpnn, heads=cfg.global_attn_heads, dropout=cfg.dropout,
                    attn_type=cfg.global_attn_type or "multihead",
                    max_nodes_per_graph=cfg.max_nodes_per_graph,
                    use_flash_attention=cfg.use_flash_attention,
                )
            convs.append(mpnn)
        self.graph_convs = nn.ModuleList(convs)
        self.feature_layers = nn.ModuleList(MaskedBatchNorm(w) for w in widths)
        self.act = get_activation(cfg.activation)

        # learnable embeddings of GPS
        if cfg.use_global_attn:
            h = cfg.hidden_dim
            self.pos_emb = Dense(cfg.pe_dim, h, bias=False)
            if cfg.input_dim:
                self.node_emb = Dense(cfg.input_dim, h, bias=False)
                self.node_lin = Dense(2 * h, h, bias=False)
            if self.is_edge_model:
                self.rel_pos_emb = Dense(cfg.pe_dim, h, bias=False)
                if cfg.use_edge_attr:
                    self.edge_emb = Dense(cfg.edge_dim, h, bias=False)
                    self.edge_lin = Dense(2 * h, h, bias=False)

        B = cfg.num_branches
        gh = cfg.graph_head or GraphHeadConfig()
        if any(t == "graph" for t in cfg.output_type):
            self.graph_shared = MLP(
                cfg.hidden_dim, (gh.dim_sharedlayers,) * gh.num_sharedlayers,
                cfg.activation, final_activation=True,
                mirror_init=cfg.decoder_mirror_init,
                recovery_slope=cfg.decoder_recovery_slope, num_branches=B,
            )
        heads = []
        for t, d in zip(cfg.output_type, cfg.output_dim):
            out_d = d * (2 if cfg.var_output else 1)
            if t == "graph":
                heads.append(MLP(
                    gh.dim_sharedlayers, tuple(gh.dim_headlayers) + (out_d,),
                    cfg.activation, mirror_init=cfg.decoder_mirror_init,
                    recovery_slope=cfg.decoder_recovery_slope, num_branches=B,
                ))
            elif t == "node":
                nh = cfg.node_head or NodeHeadConfig()
                if nh.nn_type in ("mlp", "mlp_per_node"):
                    heads.append(MLPNode(
                        cfg.hidden_dim, out_d, nh.dim_headlayers, cfg.activation,
                        cfg.decoder_mirror_init, cfg.decoder_recovery_slope, B,
                        nn_type=nh.nn_type, num_nodes=cfg.num_nodes or 0,
                    ))
                elif nh.nn_type == "conv":
                    heads.append(BranchBank(lambda d=out_d: NodeConvHead(cfg, d), B))
                else:
                    raise ValueError(f"unknown node head type {nh.nn_type!r}")
            else:
                raise ValueError(f"unknown head type {t!r}")
        self.heads_NN = nn.ModuleList(heads)
        name_probes(self)

    def _embedding(self, batch):
        """Input node features and the batch the convs see: under GPS the
        positional encodings embedded with the node features, and the
        relative encodings as edge features."""
        cfg = self.cfg
        x = batch.x
        edge_attr = batch.edge_attr if cfg.use_edge_attr else None
        if cfg.use_global_attn:
            pe = self.pos_emb(batch.pe)
            if cfg.input_dim:
                pe = self.node_lin(torch.cat([self.node_emb(x), pe], dim=1))
            x = pe
            if self.is_edge_model:
                e = self.rel_pos_emb(batch.rel_pe)
                if cfg.use_edge_attr:
                    e = self.edge_lin(torch.cat([self.edge_emb(batch.edge_attr), e], dim=1))
                edge_attr = e
        if edge_attr is not None:
            batch = batch.replace(edge_attr=edge_attr)
        return x, batch

    def encode(self, batch):
        """Conv stack -> final invariant node features [N, hidden]."""
        inv, equiv, _ = self._encode(batch)
        return inv, equiv

    def _encode(self, batch):
        """(invariant features, equivariant features, the batch the convs
        saw): the conv heads run on the same embedded batch."""
        inv, batch = self._embedding(batch)
        equiv = batch.pos
        # numerics taps (obs/numerics.py): no-ops unless a collection is
        # active (Telemetry.numerics); masked, padding rows are garbage
        probe("embedding", inv, batch.node_mask)
        for i, (conv, bn) in enumerate(zip(self.graph_convs, self.feature_layers)):
            inv, equiv = conv(inv, equiv, batch)
            inv = self.act(bn(inv, batch.node_mask, train=self.training))
            probe(f"conv{i}", inv, batch.node_mask)
        return inv, equiv, batch

    def forward(self, batch) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x, equiv, batch = self._encode(batch)
        x_graph = masked_global_mean_pool(x, batch.node_graph, batch.num_graphs,
                                          batch.node_mask, batch.graphs_contiguous)
        probe("pooled", x_graph, batch.graph_mask)
        outputs: Dict[str, torch.Tensor] = {}
        for ihead, (name, t, d) in enumerate(
            zip(cfg.output_names, cfg.output_type, cfg.output_dim)
        ):
            if t == "graph":
                stacked = self.heads_NN[ihead](self.graph_shared(x_graph))  # [B, G, d]
                row_branch = batch.dataset_id
            else:
                head = self.heads_NN[ihead]
                # [B, N, d]
                stacked = head(x, equiv, batch) if isinstance(head, BranchBank) else head(x, batch)
                row_branch = batch.dataset_id[batch.node_graph]
            out = self._select_branch(stacked, row_branch)
            outputs[name] = out[..., :d]
            probe(f"head:{name}", outputs[name],
                  batch.graph_mask if t == "graph" else batch.node_mask)
            if cfg.var_output:
                outputs[f"{name}__var"] = out[..., d:] ** 2
        return outputs

    def _select_branch(self, stacked, row_branch):
        """Dense all-branch decode + per-row branch select."""
        if self.cfg.num_branches == 1:
            return stacked[0]
        idx = row_branch.long()[None, :, None].expand(1, -1, stacked.shape[-1])
        return torch.gather(stacked, 0, idx)[0]
