"""Padded graph batches as dataclasses of tensors.

Counterpart of ``hydragnn_tpu/data/graph.py``. The host side is numpy and
produces the very same padded arrays as the JAX package, with the same
padding convention:

- all graphs of a batch are concatenated (node indices offset per graph);
- the result is padded up to a ``PadSpec`` (n_nodes, n_edges, n_graphs);
- padding nodes belong to the final (dummy) graph slot, and padding edges
  run from the last node to itself, so with receiver-sorted graphs the
  batched receivers come out globally sorted and every padding edge lands
  on the final node, whose output rows the model masks downstream.

A pad spec with ``n_triplets`` also carries DimeNet's triplet channel:
every k->j->i pair of real edges (k != i) as edge ids ``trip_kj`` /
``trip_ji``, padded with the last edge slot and masked by ``trip_mask``.

``GraphBatch`` is the device-side batch: a dataclass of tensors with
``.to(device)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# names of per-node / per-edge optional fields, used by batching
_NODE_FIELDS = ("x", "pos", "pe", "z")
_EDGE_FIELDS = ("edge_attr", "edge_shifts", "rel_pe")


@dataclasses.dataclass
class Graph:
    """A single host-side graph sample (numpy arrays, ragged shapes)."""

    x: np.ndarray  # [n, Fx] node input features
    pos: np.ndarray  # [n, 3] positions
    senders: np.ndarray  # [e] int32 message source node
    receivers: np.ndarray  # [e] int32 message destination node
    edge_attr: Optional[np.ndarray] = None  # [e, Fe]
    edge_shifts: Optional[np.ndarray] = None  # [e, 3] PBC cartesian shifts
    pe: Optional[np.ndarray] = None  # [n, pe_dim]
    rel_pe: Optional[np.ndarray] = None  # [e, pe_dim]
    z: Optional[np.ndarray] = None  # [n] int32 atomic numbers
    graph_y: Optional[np.ndarray] = None  # [Fg] raw graph feature table
    graph_targets: Optional[Dict[str, np.ndarray]] = None  # name -> [d]
    node_targets: Optional[Dict[str, np.ndarray]] = None  # name -> [n, d]
    dataset_id: int = 0
    cell: Optional[np.ndarray] = None  # [3, 3] lattice (PBC only)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    @functools.cached_property
    def num_triplets(self) -> int:
        """DimeNet's k->j->i triplets of this graph (``_triplet_count``),
        counted once: every triplet budget (pad specs, the loader's packing,
        the server's admission and batch forming) reads it here."""
        return _triplet_count(self)

    def float_channels(self):
        """``(name, array)`` for every numeric payload channel (the serving
        admission check reads this to reject non-finite requests)."""
        for name in ("x", "pos", "edge_attr", "edge_shifts", "pe", "rel_pe"):
            v = getattr(self, name)
            if v is not None:
                yield name, np.asarray(v)
        if self.graph_y is not None:
            yield "graph_y", np.asarray(self.graph_y)
        for table, label in ((self.graph_targets, "graph_target"),
                             (self.node_targets, "node_target")):
            for key, v in (table or {}).items():
                yield f"{label}:{key}", np.asarray(v)


@dataclasses.dataclass
class GraphBatch:
    """Padded batch of graphs. N = padded node count, E = padded edge
    count, G = padded graph count; the last graph slot is the dummy graph
    holding every padding node and edge (``graph_mask`` False there)."""

    x: torch.Tensor  # [N, Fx]
    pos: torch.Tensor  # [N, 3]
    node_graph: torch.Tensor  # [N] int64
    node_mask: torch.Tensor  # [N] bool
    senders: torch.Tensor  # [E] int64
    receivers: torch.Tensor  # [E] int64
    edge_mask: torch.Tensor  # [E] bool
    graph_mask: torch.Tensor  # [G] bool
    dataset_id: torch.Tensor  # [G] int64
    edge_attr: Optional[torch.Tensor] = None
    edge_shifts: Optional[torch.Tensor] = None
    pe: Optional[torch.Tensor] = None
    rel_pe: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    # DimeNet's triplets k->j->i as edge ids (a pad spec with n_triplets)
    trip_kj: Optional[torch.Tensor] = None  # [T] int64 edge id of k->j
    trip_ji: Optional[torch.Tensor] = None  # [T] int64 edge id of j->i
    trip_mask: Optional[torch.Tensor] = None  # [T] bool
    graph_targets: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    node_targets: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # node_graph ascends (each graph's nodes contiguous): true where the
    # host built the batch (batch_graphs), so the pooling can sum in node
    # order without checking the ids on the device
    graphs_contiguous: bool = False

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def num_graphs(self) -> int:
        return int(self.graph_mask.shape[0])

    @property
    def nodes_per_graph(self) -> torch.Tensor:
        """[G] int32 number of real nodes in each graph."""
        seg = torch.zeros(self.num_graphs, dtype=torch.int32, device=self.device)
        return seg.index_add_(0, self.node_graph, self.node_mask.to(torch.int32))

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def apply(self, fn) -> "GraphBatch":
        """A new batch with ``fn(tensor)`` in place of each tensor, visited
        in field order (the target tables by their insertion order)."""
        def mv(v):
            return None if v is None else fn(v)

        kw = {
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in ("graph_targets", "node_targets", "graphs_contiguous")
        }
        return GraphBatch(
            graph_targets={k: mv(v) for k, v in self.graph_targets.items()},
            node_targets={k: mv(v) for k, v in self.node_targets.items()},
            graphs_contiguous=self.graphs_contiguous,
            **kw,
        )

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        return self.apply(lambda v: v.to(device, non_blocking=non_blocking))


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static padding target for a batch."""

    n_nodes: int
    n_edges: int
    n_graphs: int  # includes the +1 dummy graph slot
    n_triplets: int = 0  # 0 = no triplet channel

    @staticmethod
    def for_dataset(graphs: List[Graph], batch_size: int, node_multiple: int = 8,
                    edge_multiple: int = 128, slack: float = 1.0,
                    with_triplets: bool = False) -> "PadSpec":
        """One spec covering any ``batch_size`` graphs of ``graphs``: the sum
        of the largest sizes (times ``slack``), rounded up; with
        ``with_triplets`` the exact triplet counts too."""
        if not graphs:
            raise ValueError("empty dataset")
        n_sizes = sorted((g.num_nodes for g in graphs), reverse=True)
        e_sizes = sorted((g.num_edges for g in graphs), reverse=True)
        k = min(batch_size, len(n_sizes))
        n_bound = int(sum(n_sizes[:k]) * slack) + 1
        e_bound = int(sum(e_sizes[:k]) * slack) + 1
        n_triplets = 0
        if with_triplets:
            t_sizes = sorted((g.num_triplets for g in graphs), reverse=True)
            n_triplets = _round_up(int(sum(t_sizes[:k]) * slack) + 1, edge_multiple)
        return PadSpec(
            n_nodes=_round_up(n_bound + 1, node_multiple),
            n_edges=_round_up(e_bound, edge_multiple),
            n_graphs=batch_size + 1,
            n_triplets=n_triplets,
        )


# batches per size-sorted window of size-bucketed batching (the loader's
# composition and the ladder's simulation of it)
BUCKET_WINDOW = 16


@dataclasses.dataclass(frozen=True)
class SpecLadder:
    """A small ascending set of pad specs: each batch takes the smallest
    level that fits it (the JAX package's variable-graph-size strategy,
    kept so the served shapes are the same few levels)."""

    specs: Tuple[PadSpec, ...]  # ascending; last is the exact worst case

    @staticmethod
    def for_dataset(
        graphs: List[Graph],
        batch_size: int,
        num_buckets: int = 4,
        node_multiple: int = 8,
        edge_multiple: int = 128,
        with_triplets: bool = False,
        num_sim: int = 256,
        seed: int = 0,
        size_bucketing: bool = False,
    ) -> "SpecLadder":
        """Levels at quantiles of simulated batch totals, plus the exact
        worst case. The simulation follows the loader's composition: under
        ``size_bucketing`` batches of like-sized graphs (sorted windows of
        ``BUCKET_WINDOW`` batches), else random batches."""
        n_sizes = np.asarray([g.num_nodes for g in graphs])
        e_sizes = np.asarray([g.num_edges for g in graphs])
        t_sizes = (np.asarray([g.num_triplets for g in graphs]) if with_triplets
                   else None)
        k = min(batch_size, len(graphs))
        worst = PadSpec(
            n_nodes=_round_up(int(np.sort(n_sizes)[-k:].sum()) + 2, node_multiple),
            n_edges=_round_up(int(np.sort(e_sizes)[-k:].sum()) + 1, edge_multiple),
            n_graphs=batch_size + 1,
            n_triplets=(_round_up(int(np.sort(t_sizes)[-k:].sum()) + 1, edge_multiple)
                        if t_sizes is not None else 0),
        )
        if num_buckets <= 1 or len(graphs) <= batch_size:
            return SpecLadder((worst,))
        rng = np.random.default_rng(seed)
        if size_bucketing:
            picks_l: List[np.ndarray] = []
            w = max(BUCKET_WINDOW * k, k)
            while len(picks_l) < num_sim:
                order = rng.permutation(len(graphs))
                for s in range(0, len(order) - k + 1, w):
                    win = order[s: s + w]
                    win = win[np.argsort(n_sizes[win], kind="stable")]
                    picks_l.extend(win[b: b + k] for b in range(0, len(win) - k + 1, k))
            picks = np.stack(picks_l[:num_sim])
        else:
            picks = np.stack(
                [rng.choice(len(graphs), size=k, replace=False) for _ in range(num_sim)]
            )
        node_tot = n_sizes[picks].sum(axis=1)
        edge_tot = e_sizes[picks].sum(axis=1)
        trip_tot = t_sizes[picks].sum(axis=1) if t_sizes is not None else None
        # tail-halving quantiles (50, 75, 87.5, ...) plus a level just above
        # the largest simulated batch
        qs = [100.0 * (1.0 - 0.5 ** (i + 1)) for i in range(num_buckets - 1)]
        levels = [
            (int(np.percentile(node_tot, q)) + 2, int(np.percentile(edge_tot, q)) + 1,
             int(np.percentile(trip_tot, q)) + 1 if trip_tot is not None else 0)
            for q in qs
        ]
        levels.append((int(node_tot.max() * 1.05) + 2, int(edge_tot.max() * 1.05) + 1,
                       int(trip_tot.max() * 1.05) + 1 if trip_tot is not None else 0))
        specs: List[PadSpec] = []
        for n_b, e_b, t_b in levels:
            spec = PadSpec(
                n_nodes=_round_up(n_b, node_multiple),
                n_edges=_round_up(e_b, edge_multiple),
                n_graphs=worst.n_graphs,
                n_triplets=_round_up(t_b, edge_multiple) if t_b else 0,
            )
            if spec.n_nodes < worst.n_nodes and (not specs or spec != specs[-1]):
                specs.append(spec)
        specs.append(worst)
        return SpecLadder(tuple(specs))

    def select(self, node_total: int, edge_total: int, trip_total: int = 0) -> PadSpec:
        """Smallest spec fitting the batch; the top level fits any batch of
        at most ``batch_size`` dataset graphs."""
        for s in self.specs:
            if (node_total <= s.n_nodes - 1 and edge_total <= s.n_edges
                    and (s.n_triplets == 0 or trip_total <= s.n_triplets)):
                return s
        return self.specs[-1]

    def select_for(self, graphs: List[Graph]) -> PadSpec:
        t = sum(g.num_triplets for g in graphs) if self.specs[-1].n_triplets else 0
        return self.select(
            sum(g.num_nodes for g in graphs), sum(g.num_edges for g in graphs), t
        )


def _triplet_count(g: Graph) -> int:
    """The graph's k->j->i triplets: for each edge j->i, one per in-edge
    k->j of j with k != i."""
    deg = np.bincount(g.receivers, minlength=g.num_nodes)
    total = int(deg[g.senders].sum())
    # minus the k == i cases: the distinct pairs j->i whose reverse i->j is
    # an edge too
    n = np.int64(max(g.num_nodes, 1))
    s, r = np.asarray(g.senders, np.int64), np.asarray(g.receivers, np.int64)
    pairs = np.unique(s * n + r)
    mutual = int(np.isin((pairs % n) * n + pairs // n, pairs).sum())
    return total - mutual


def compute_triplets_np(senders: np.ndarray, receivers: np.ndarray, edge_mask: np.ndarray,
                        n_triplets: int) -> Dict[str, np.ndarray]:
    """Every k->j->i triplet over the real edges of a padded batch, as edge
    ids ``trip_kj`` / ``trip_ji`` (ascending ``trip_ji``), padded to
    ``n_triplets`` with the last edge slot, and their ``trip_mask``."""
    real = np.nonzero(edge_mask)[0]
    n_nodes = int(senders.max(initial=0)) + 1 if senders.size else 1
    # in-edges grouped by receiver
    order = np.argsort(receivers[real], kind="stable")
    sorted_edges = real[order]
    deg = np.bincount(receivers[real], minlength=n_nodes)
    start = np.concatenate([[0], np.cumsum(deg)])
    # for each real edge j->i, a block of deg[j] candidate edges k->j
    j_of = senders[real]
    counts = deg[j_of]
    ji = np.repeat(real, counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(int(counts.sum())) - np.repeat(cum[:-1], counts)
    kj = sorted_edges[np.repeat(start[j_of], counts) + pos]
    keep = senders[kj] != receivers[ji]  # drop k == i
    kj, ji = kj[keep], ji[keep]
    t = kj.shape[0]
    if t > n_triplets:
        raise ValueError(f"batch has {t} triplets, exceeds pad spec {n_triplets}")
    pad_edge = senders.shape[0] - 1
    out_kj = np.full((n_triplets,), pad_edge, np.int32)
    out_ji = np.full((n_triplets,), pad_edge, np.int32)
    out_kj[:t] = kj
    out_ji[:t] = ji
    mask = np.zeros((n_triplets,), bool)
    mask[:t] = True
    return {"trip_kj": out_kj, "trip_ji": out_ji, "trip_mask": mask}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stack_optional(graphs: List[Graph], field: str) -> Optional[np.ndarray]:
    vals = [getattr(g, field) for g in graphs]
    if all(v is None for v in vals):
        return None
    if any(v is None for v in vals):
        raise ValueError(f"field {field!r} present in some graphs but not all")
    return np.concatenate([np.asarray(v) for v in vals], axis=0)


def sort_edges_by_receiver(graph: Graph) -> Graph:
    """Reorder a graph's edges so receivers ascend (stable sort): the
    precondition of the sorted-segment kernels. All per-edge arrays are
    permuted together."""
    perm = np.argsort(graph.receivers, kind="stable")
    rep = {
        "senders": np.asarray(graph.senders)[perm],
        "receivers": np.asarray(graph.receivers)[perm],
    }
    for field in _EDGE_FIELDS:
        v = getattr(graph, field)
        if v is not None:
            rep[field] = np.asarray(v)[perm]
    return dataclasses.replace(graph, **rep)


def batch_graphs_np(
    graphs: List[Graph],
    spec: PadSpec,
    np_dtype=np.float32,
    sort_edges: bool = False,
) -> Dict[str, np.ndarray]:
    """Concatenate + pad a list of host graphs into flat numpy arrays, with
    the padding convention of the module docstring. ``sort_edges=True``
    sorts each graph's edges by receiver first."""
    if sort_edges:
        graphs = [sort_edges_by_receiver(g) for g in graphs]
    G = len(graphs)
    n = sum(g.num_nodes for g in graphs)
    e = sum(g.num_edges for g in graphs)
    if G > spec.n_graphs - 1 or n > spec.n_nodes - 1 or e > spec.n_edges:
        raise ValueError(
            f"batch ({G} graphs, {n} nodes, {e} edges) exceeds pad spec {spec}"
        )

    out: Dict[str, np.ndarray] = {}
    for field in _NODE_FIELDS:
        stacked = _stack_optional(graphs, field)
        if stacked is None:
            continue
        if stacked.ndim == 1:
            stacked = stacked[:, None]
        dtype = np.int32 if field == "z" else np_dtype
        buf = np.zeros((spec.n_nodes, stacked.shape[1]), dtype)
        buf[:n] = stacked
        out[field] = buf if field != "z" else buf[:, 0]

    senders = np.full((spec.n_edges,), spec.n_nodes - 1, np.int32)
    receivers = np.full((spec.n_edges,), spec.n_nodes - 1, np.int32)
    node_graph = np.full((spec.n_nodes,), spec.n_graphs - 1, np.int32)
    off = eoff = 0
    for gi, g in enumerate(graphs):
        senders[eoff : eoff + g.num_edges] = g.senders + off
        receivers[eoff : eoff + g.num_edges] = g.receivers + off
        node_graph[off : off + g.num_nodes] = gi
        off += g.num_nodes
        eoff += g.num_edges
    out["senders"] = senders
    out["receivers"] = receivers
    out["node_graph"] = node_graph

    for field in _EDGE_FIELDS:
        stacked = _stack_optional(graphs, field)
        if stacked is None:
            continue
        if stacked.ndim == 1:
            stacked = stacked[:, None]
        buf = np.zeros((spec.n_edges, stacked.shape[1]), np_dtype)
        buf[:e] = stacked
        out[field] = buf

    node_mask = np.zeros((spec.n_nodes,), bool)
    node_mask[:n] = True
    edge_mask = np.zeros((spec.n_edges,), bool)
    edge_mask[:e] = True
    if spec.n_triplets:
        out.update(compute_triplets_np(senders, receivers, edge_mask, spec.n_triplets))
    graph_mask = np.zeros((spec.n_graphs,), bool)
    graph_mask[:G] = True
    out["node_mask"] = node_mask
    out["edge_mask"] = edge_mask
    out["graph_mask"] = graph_mask

    dataset_id = np.zeros((spec.n_graphs,), np.int32)
    dataset_id[:G] = [g.dataset_id for g in graphs]
    out["dataset_id"] = dataset_id

    gt_names, nt_names = set(), set()
    for g in graphs:
        gt_names.update((g.graph_targets or {}).keys())
        nt_names.update((g.node_targets or {}).keys())
    for name in sorted(gt_names):
        vals = [np.atleast_1d(np.asarray(g.graph_targets[name], np_dtype)) for g in graphs]
        buf = np.zeros((spec.n_graphs, vals[0].shape[-1]), np_dtype)
        buf[:G] = np.stack(vals)
        out[f"graph_targets/{name}"] = buf
    for name in sorted(nt_names):
        vals = np.concatenate(
            [np.asarray(g.node_targets[name], np_dtype).reshape(g.num_nodes, -1)
             for g in graphs]
        )
        buf = np.zeros((spec.n_nodes, vals.shape[1]), np_dtype)
        buf[:n] = vals
        out[f"node_targets/{name}"] = buf
    return out


# index arrays become int64 tensors: torch indexing and index_add_ take
# int64, and the kernels' wrappers narrow to int32 themselves
_INDEX_FIELDS = ("senders", "receivers", "node_graph", "dataset_id", "z", "trip_kj", "trip_ji")


def graph_batch_from_np(arrs: Dict[str, np.ndarray]) -> GraphBatch:
    """Assemble a CPU ``GraphBatch`` from ``batch_graphs_np`` output (whose
    graphs are contiguous along the node axis)."""

    def t(k, v):
        v = torch.from_numpy(np.ascontiguousarray(v))
        return v.long() if k in _INDEX_FIELDS else v

    graph_targets = {
        k.split("/", 1)[1]: t(k, v) for k, v in arrs.items()
        if k.startswith("graph_targets/")
    }
    node_targets = {
        k.split("/", 1)[1]: t(k, v) for k, v in arrs.items()
        if k.startswith("node_targets/")
    }
    kwargs = {k: t(k, v) for k, v in arrs.items() if "/" not in k}
    return GraphBatch(graph_targets=graph_targets, node_targets=node_targets,
                      graphs_contiguous=True, **kwargs)


def batch_graphs(
    graphs: List[Graph], spec: PadSpec, sort_edges: bool = False
) -> GraphBatch:
    return graph_batch_from_np(batch_graphs_np(graphs, spec, sort_edges=sort_edges))
