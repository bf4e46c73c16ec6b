"""Dataset -> model-ready batches: variable selection, split, min-max, loader.

Counterpart of ``hydragnn_tpu/data/pipeline.py`` for a single host. Host
work is numpy and gives the same padded arrays as the JAX package for the
same graphs, seed and settings; ``GraphLoader`` yields CPU ``GraphBatch``es
that the caller moves to its device (train/loop.py ``device_prefetch``
stages them ahead on a side stream): shuffled or weighted draws with
replacement (``oversampling``, ``num_samples``, ``sample_weights``; the
per-branch ``branch_sample_weights``), size-bucketed composition, packing,
the sample validator's gate, per-rank sharding (``host_count`` /
``host_index``: each rank of a data-parallel run draws its own 1/world
of every epoch, in lockstep with the others), and the bounded prefetch
producer thread with its stall watchdog (``prefetch``, ``stall_timeout``,
``LoaderStallError``). Not ported here: stacked shards and the mixture
plane.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .graph import (
    BUCKET_WINDOW,
    Graph,
    GraphBatch,
    PadSpec,
    SpecLadder,
    _round_up,
    batch_graphs,
)


# prefetch watchdog cadence: how often the consumer wakes to check the
# producer's liveness and the stall clock, and how long the teardown join
# waits before declaring the producer thread leaked (module-level so tests
# can pin them)
_WATCHDOG_TICK_S = 0.1
_PRODUCER_JOIN_TIMEOUT_S = 2.0


class Producer:
    """A daemon thread that puts what ``items()`` yields into a queue of
    ``depth`` slots, then ``END``; an exception it raises is re-raised by
    ``get`` in the consumer. ``items`` is called in the thread. The
    loader's prefetch and the loop's device staging (train/loop.py
    ``device_prefetch``) both run on it."""

    END = object()

    def __init__(self, items, depth: int, name: str):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(items,), daemon=True, name=name)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, items) -> None:
        try:
            for item in items():
                if not self._put(item):
                    return
            self._put(self.END)
        except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
            self._put(_Raised(e))

    def get(self, timeout: Optional[float] = None, block: bool = True):
        """The next item, ``END``, or the producer's exception raised;
        ``queue.Empty`` when nothing came within ``timeout``."""
        item = self.q.get(block=block, timeout=timeout)
        if isinstance(item, _Raised):
            raise item.error
        return item

    def close(self, join_s: float) -> bool:
        """Stop the producer and join it for at most ``join_s`` seconds;
        True where it is still alive (blocked inside ``items``)."""
        self.stop.set()
        self.thread.join(timeout=join_s)
        return self.thread.is_alive()


@dataclasses.dataclass
class _Raised:
    error: BaseException


class LoaderStallError(RuntimeError):
    """The prefetch producer thread died without delivering its end-of-epoch
    sentinel, or produced nothing for longer than
    ``Training.loader_stall_timeout``: a wedged worker (deadlocked fetch,
    hung filesystem) that would otherwise hang the run on a bare queue get.
    The message names the batch cursor so the stall is attributable."""


def _pack_spec(graphs: Sequence[Graph], per_shard: int, with_triplets: bool = False) -> PadSpec:
    """Budget spec for packed batching: mean size * per_shard (+5%
    headroom), never below the largest single graph, with 2x graph slots so
    bins of small graphs are not cut short by the slot cap. ``with_triplets``
    budgets DimeNet's triplet channel the same way."""
    ns = np.asarray([g.num_nodes for g in graphs])
    es = np.asarray([g.num_edges for g in graphs])
    budget_n = max(int(ns.mean() * per_shard * 1.05) + 2, int(ns.max()) + 2)
    budget_e = max(int(es.mean() * per_shard * 1.05) + 1, int(es.max()) + 1)
    n_triplets = 0
    if with_triplets:
        ts = np.asarray([g.num_triplets for g in graphs])
        n_triplets = _round_up(
            max(int(ts.mean() * per_shard * 1.05) + 1, int(ts.max()) + 1), 128
        )
    return PadSpec(
        n_nodes=_round_up(budget_n, 8),
        n_edges=_round_up(budget_e, 128),
        n_graphs=2 * per_shard + 1,
        n_triplets=n_triplets,
    )


def selectable_levels(
    graphs: Sequence[Graph], ladder: SpecLadder
) -> List[Tuple[int, Graph]]:
    """(level index, one fitting graph) for every ladder level the graphs
    can land in: exactly the set of shapes batching over them can produce."""
    out: List[Tuple[int, Graph]] = []
    for li, spec in enumerate(ladder.specs):
        g = next(
            (c for c in graphs
             if c.num_nodes <= spec.n_nodes - 1 and c.num_edges <= spec.n_edges
             and (not spec.n_triplets or c.num_triplets <= spec.n_triplets)),
            None,
        )
        if g is not None:
            out.append((li, g))
    return out


def spec_template_batches(
    graphs: Sequence[Graph], ladder: SpecLadder, sort_edges: bool = False
) -> List[Tuple[PadSpec, GraphBatch]]:
    """One template batch per reachable ladder level (the serving
    warm-up inputs): a single fitting graph padded to the level."""
    return [
        (ladder.specs[li], batch_graphs([g], ladder.specs[li], sort_edges=sort_edges))
        for li, g in selectable_levels(graphs, ladder)
    ]


@dataclasses.dataclass
class VariablesOfInterest:
    """Selection of model inputs and per-head targets from raw feature
    tables (config ``NeuralNetwork.Variables_of_interest`` +
    ``Dataset.{node,graph}_features``)."""

    input_node_features: Sequence[int]
    output_names: Sequence[str]
    output_types: Sequence[str]  # "graph" | "node"
    output_index: Sequence[int]
    node_feature_dims: Sequence[int]
    graph_feature_dims: Sequence[int]

    def node_feature_slice(self, idx: int) -> slice:
        off = int(np.sum(self.node_feature_dims[:idx]))
        return slice(off, off + self.node_feature_dims[idx])

    def graph_feature_slice(self, idx: int) -> slice:
        off = int(np.sum(self.graph_feature_dims[:idx]))
        return slice(off, off + self.graph_feature_dims[idx])

    @property
    def input_dim(self) -> int:
        return int(sum(self.node_feature_dims[i] for i in self.input_node_features))


def select_input_columns(graph: Graph, voi: VariablesOfInterest) -> Graph:
    """Keep only the configured input node-feature columns of ``graph.x``."""
    in_cols = np.concatenate([
        np.arange(voi.node_feature_slice(i).start, voi.node_feature_slice(i).stop)
        for i in voi.input_node_features
    ])
    return dataclasses.replace(graph, x=np.asarray(graph.x)[:, in_cols])


def extract_variables(graph: Graph, voi: VariablesOfInterest) -> Graph:
    """Model-ready graph: input columns + per-head target dicts."""
    graph_targets: Dict[str, np.ndarray] = {}
    node_targets: Dict[str, np.ndarray] = {}
    for name, t, idx in zip(voi.output_names, voi.output_types, voi.output_index):
        if t == "graph":
            graph_targets[name] = np.asarray(graph.graph_y)[voi.graph_feature_slice(idx)]
        else:
            node_targets[name] = np.asarray(graph.x)[:, voi.node_feature_slice(idx)]
    return dataclasses.replace(
        select_input_columns(graph, voi),
        graph_targets=graph_targets,
        node_targets=node_targets,
    )


@dataclasses.dataclass
class MinMax:
    """Per-column min/max used to normalize features/targets to [0, 1],
    and to take predictions back to the data's units."""

    x_min: np.ndarray
    x_max: np.ndarray
    y_min: np.ndarray
    y_max: np.ndarray

    @staticmethod
    def fit(graphs: List[Graph]) -> "MinMax":
        xs = np.concatenate([g.x for g in graphs], axis=0)
        if graphs[0].graph_y is not None:
            ys = np.stack([np.asarray(g.graph_y) for g in graphs])
            y_min, y_max = ys.min(0), ys.max(0)
        else:
            y_min = y_max = np.zeros((0,), np.float32)
        return MinMax(xs.min(0), xs.max(0), y_min, y_max)

    def apply(self, graphs: List[Graph]) -> List[Graph]:
        xr = np.where(self.x_max > self.x_min, self.x_max - self.x_min, 1.0)
        yr = np.where(self.y_max > self.y_min, self.y_max - self.y_min, 1.0)
        out = []
        for g in graphs:
            x = (g.x - self.x_min) / xr
            gy = None if g.graph_y is None else (g.graph_y - self.y_min) / yr
            out.append(dataclasses.replace(g, x=x.astype(np.float32), graph_y=gy))
        return out

    def denormalize_graph(self, y: np.ndarray, idx: slice) -> np.ndarray:
        """A graph head's values (columns ``idx`` of the graph features) in
        the data's units."""
        return y * (self.y_max[idx] - self.y_min[idx]) + self.y_min[idx]

    def denormalize_node(self, y: np.ndarray, idx: slice) -> np.ndarray:
        """A node head's values in the data's units: node heads come from
        the normalized ``graph.x`` columns ``idx``, so their scale is the x
        min/max."""
        lo, hi = self.x_min[idx], self.x_max[idx]
        return y * np.where(hi > lo, hi - lo, 1.0) + lo


def split_dataset(
    graphs: List[Graph], perc_train: float, seed: int = 0, stratified: bool = False
) -> Tuple[List[Graph], List[Graph], List[Graph]]:
    """Random train/val/test split; val and test share the remainder.
    ``stratified`` groups the graphs by composition (the histogram of
    ``z``), shuffles each group and deals the groups round-robin
    (``_deal_order``), so each split sees every composition."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(graphs))
    if stratified:
        groups: Dict[tuple, list] = {}
        for i, g in enumerate(graphs):
            key = tuple(np.bincount(np.asarray(g.z, np.int64) if g.z is not None else [0]))
            groups.setdefault(key, []).append(i)
        order = []
        for key in sorted(groups):
            sub = np.array(groups[key])
            rng.shuffle(sub)
            order.append(sub)
        idx = np.concatenate(order) if order else idx
        idx = idx[_deal_order(len(idx))]
    else:
        rng.shuffle(idx)
    n_train = int(len(idx) * perc_train)
    n_val = (len(idx) - n_train) // 2
    return (
        [graphs[i] for i in idx[:n_train]],
        [graphs[i] for i in idx[n_train : n_train + n_val]],
        [graphs[i] for i in idx[n_train + n_val :]],
    )


def _deal_order(n: int) -> np.ndarray:
    """Round-robin dealing permutation: 0, k, 2k, ..., 1, k+1, ... with k=10."""
    k = 10
    return np.concatenate([np.arange(s, n, k) for s in range(k)])


def branch_sample_weights(graphs: Sequence[Graph]) -> np.ndarray:
    """Per-sample draw weights giving every branch (``dataset_id``) the
    same share of the draws, whatever its sample count
    (``Training.balance_branch_sampling``)."""
    ids = np.asarray([g.dataset_id for g in graphs], np.int64)
    _, inverse, counts = np.unique(ids, return_inverse=True, return_counts=True)
    return 1.0 / counts[inverse].astype(np.float64)


def check_in_degree(graphs: Sequence[Graph], max_in_degree: int) -> None:
    """Raise when a graph's real in-degree exceeds the configured bound
    that ``max_in_degree`` promises the sorted-aggregation path."""
    for gi, g in enumerate(graphs):
        if g.num_edges:
            top = int(np.bincount(np.asarray(g.receivers), minlength=g.num_nodes).max())
            if top > int(max_in_degree):
                raise ValueError(
                    f"graph {gi} has in-degree {top} > max_in_degree "
                    f"{max_in_degree}; raise Architecture.max_in_degree"
                )


class GraphLoader:
    """Shuffling, statically padded batch iterator over a list of graphs.

    ``spec`` is a ``PadSpec``, a ``SpecLadder`` or None (a ladder of
    ``num_buckets`` levels is built from the data). ``pack=True`` bins
    consecutive graphs greedily into ONE budget with a variable real-graph
    count per batch. ``sort_edges`` sorts receivers (the sorted-aggregation
    precondition). ``with_triplets`` budgets DimeNet's triplet channel in a
    spec built here; a given spec carries it in its ``n_triplets``.

    An epoch's index stream is a pure function of (``seed``, epoch): with
    ``oversampling`` ``num_samples`` (default: the dataset size) draws with
    replacement, weighted by ``sample_weights`` when given; otherwise the
    (shuffled) indices, cut to ``num_samples`` when set.
    ``size_bucketing`` sorts windows of ``BUCKET_WINDOW * batch_size``
    samples by node count and shuffles the order of the resulting batches.
    ``validator`` (``data.validate.SampleValidator``) drops or raises on
    bad samples at construction (under a given spec, graphs over its
    budget too) and on graphs over the pack budget; ``source`` names this
    loader in its tally.

    ``host_count`` / ``host_index`` give each rank of a data-parallel run
    its share, with ``DistributedSampler`` semantics: every rank draws the
    same epoch stream, cuts it to a multiple of the world size and takes
    every ``host_count``-th sample from ``host_index`` on, so the ranks
    hold disjoint, equal shares. Every rank must take the same number of
    steps in an epoch (a rank with one batch fewer would leave the others
    waiting in a collective): with full batches (``drop_last``) equal
    shares give equal counts, and a packed loader simulates every rank's
    packing from the shared stream and stops at the smallest count, with
    no collective. Each rank picks its own ladder level per batch: the
    collectives of a step move parameter-shaped tensors only, so the ranks'
    batch shapes need not agree.

    ``prefetch`` > 0 builds up to that many batches ahead in a bounded
    producer thread (the same batches in the same order as without it);
    the consumer waits on it with a watchdog: a producer that died without
    its end-of-epoch sentinel, or that produced nothing for
    ``stall_timeout`` seconds (0 disables the clock), raises
    ``LoaderStallError``, counted in ``hydragnn_loader_stalls_total`` and
    emitted as a ``loader_stall`` event; ``hydragnn_loader_prefetch_depth``
    is the queue's depth at each hand-off. An exception in the producer
    reaches the consumer; an abandoned epoch stops the producer and joins
    it (a warning where it stays blocked in a batch build)."""

    def __init__(
        self,
        graphs: List[Graph],
        batch_size: int,
        spec=None,
        shuffle: bool = True,
        seed: int = 0,
        host_count: int = 1,
        host_index: int = 0,
        drop_last: bool = False,
        num_buckets: int = 1,
        sort_edges: bool = False,
        max_in_degree: Optional[int] = None,
        pack: bool = False,
        with_triplets: bool = False,
        oversampling: bool = False,
        num_samples: Optional[int] = None,
        sample_weights: Optional[np.ndarray] = None,
        size_bucketing: bool = False,
        validator=None,
        source: str = "dataset",
        prefetch: int = 0,
        stall_timeout: float = 600.0,
    ):
        self.validator = validator
        self.source = source
        self.prefetch = int(prefetch)
        self.stall_timeout = float(stall_timeout or 0.0)
        if validator is not None:
            # content checks always; budget caps only under a given spec
            worst = spec.specs[-1] if isinstance(spec, SpecLadder) else spec
            graphs = validator.filter(
                graphs, source=source,
                max_nodes=worst.n_nodes - 1 if worst is not None else None,
                max_edges=worst.n_edges if worst is not None else None,
            )
        self.graphs = graphs
        self.batch_size = batch_size
        self.pack = bool(pack)
        if self.pack:
            if isinstance(spec, SpecLadder):
                spec = spec.specs[-1]
            self.ladder = SpecLadder((spec if spec is not None
                                      else _pack_spec(graphs, batch_size, with_triplets),))
        elif spec is None:
            self.ladder = SpecLadder.for_dataset(graphs, batch_size, num_buckets=num_buckets,
                                                 with_triplets=with_triplets,
                                                 size_bucketing=size_bucketing)
        elif isinstance(spec, SpecLadder):
            self.ladder = spec
        else:
            self.ladder = SpecLadder((spec,))
        self.spec = self.ladder.specs[-1]
        self.shuffle = shuffle
        self.seed = seed
        if not 0 <= int(host_index) < int(host_count):
            raise ValueError(f"host_index {host_index} outside host_count {host_count}")
        self.host_count = int(host_count)
        self.host_index = int(host_index)
        self.drop_last = drop_last
        self.sort_edges = sort_edges
        if sort_edges and max_in_degree:
            check_in_degree(graphs, max_in_degree)
        self.oversampling = bool(oversampling)
        self.num_samples = num_samples
        if sample_weights is not None:
            if not oversampling:
                raise ValueError("sample_weights requires oversampling=True")
            w = np.asarray(sample_weights, np.float64)
            if w.shape != (len(graphs),):
                raise ValueError(f"sample_weights shape {w.shape} != ({len(graphs)},)")
            sample_weights = w / w.sum()
        self.sample_weights = sample_weights
        self.size_bucketing = bool(size_bucketing)
        self._node_counts = (np.asarray([g.num_nodes for g in graphs], np.int64)
                             if self.size_bucketing else None)
        self.epoch = 0
        # mid-epoch resume: the first ``start_batch`` batches of the epoch
        # are skipped without being built. The epoch's order is a pure
        # function of (seed, epoch), so (epoch, cursor) is the loader's
        # whole state and the remaining batches replay in the order an
        # uninterrupted run would have seen
        self.start_batch = 0
        self._resume: Optional[Tuple[int, int]] = None
        self._groups_cache: Optional[Tuple[Tuple[int, int], List[List[int]]]] = None

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for ``epoch``. The first call after
        ``resume()`` keeps the armed (epoch, cursor) instead, so the resumed
        run's first epoch replays the interrupted epoch's tail."""
        if self._resume is not None:
            self.epoch, self.start_batch = self._resume
            self._resume = None
        else:
            self.epoch = epoch
            self.start_batch = 0

    def resume(self, epoch: int, next_batch: int) -> None:
        """Arm mid-epoch resume at (``epoch``, ``next_batch``): applied now
        and kept through the next ``set_epoch``, once."""
        self.epoch = int(epoch)
        self.start_batch = int(next_batch)
        self._resume = (int(epoch), int(next_batch))

    def state_dict(self, next_batch: int = 0) -> Dict[str, int]:
        """The loader's position for a checkpoint (``LoaderState``): these
        four ints fix the remaining batch stream."""
        return {"seed": int(self.seed), "epoch": int(self.epoch),
                "next_batch": int(next_batch), "num_batches": int(len(self))}

    def _global_indices(self) -> np.ndarray:
        """The epoch's whole index stream, the same on every rank; over more
        than one rank cut to a multiple of the world size (equal shares)."""
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.oversampling:
            n = self.num_samples or len(self.graphs)
            idx = rng.choice(len(self.graphs), size=n, replace=True, p=self.sample_weights)
        else:
            idx = np.arange(len(self.graphs))
            if self.shuffle:
                rng.shuffle(idx)
            if self.num_samples is not None:
                idx = idx[: self.num_samples]
        if self.host_count > 1:
            idx = idx[: len(idx) // self.host_count * self.host_count]
        return idx

    def _local_indices(self, host: Optional[int] = None) -> np.ndarray:
        """Rank ``host``'s share (this rank's when None) of the stream."""
        h = self.host_index if host is None else host
        return self._global_indices()[h :: self.host_count]

    def _indices(self, host: Optional[int] = None) -> np.ndarray:
        idx = self._local_indices(host)
        if self.size_bucketing and len(idx) > self.batch_size:
            idx = self._bucket_order(idx)
        return idx

    def _bucket_order(self, idx: np.ndarray) -> np.ndarray:
        """``idx`` reordered so that consecutive ``batch_size`` slices hold
        graphs of like size: sorted by node count within shuffled windows
        of ``BUCKET_WINDOW * batch_size`` samples (the whole set when not
        shuffling), then the full batches' order shuffled. The remainder
        keeps its place at the end."""
        bs = self.batch_size
        n_full = len(idx) // bs
        head, tail = idx[: n_full * bs], idx[n_full * bs:]
        w = max(BUCKET_WINDOW * bs if self.shuffle else len(head), bs)
        parts = []
        for s in range(0, len(head), w):
            win = head[s: s + w]
            parts.append(win[np.argsort(self._node_counts[win], kind="stable")])
        head = np.concatenate(parts) if parts else head
        if self.shuffle and n_full > 1:
            rng = np.random.default_rng((self.seed + self.epoch) ^ 0x5EEDB)
            head = head.reshape(n_full, bs)[rng.permutation(n_full)].reshape(-1)
        return np.concatenate([head, tail])

    def _pack_groups(self, idx: np.ndarray) -> List[List[int]]:
        """Greedy stream packing: consecutive samples accumulate into a bin
        until the next one would overflow the node/edge/triplet budget or
        the graph-slot cap."""
        spec = self.spec
        cap_n, cap_e, cap_g = spec.n_nodes - 1, spec.n_edges, spec.n_graphs - 1
        cap_t = spec.n_triplets
        groups: List[List[int]] = []
        cur: List[int] = []
        n = e = t = 0
        for i in idx:
            g = self.graphs[i]
            gn, ge = g.num_nodes, g.num_edges
            gt = g.num_triplets if cap_t else 0
            if gn > cap_n or ge > cap_e or gt > cap_t:
                if self.validator is not None:  # dropped and counted, or raised
                    self.validator.reject(
                        g, int(i), "budget_overflow", source=self.source,
                        detail=f"nodes={gn}, edges={ge}, triplets={gt} vs pack budget {spec}")
                    continue
                raise ValueError(
                    f"graph {i} (nodes={gn}, edges={ge}"
                    + (f", triplets={gt}" if cap_t else "")
                    + f") exceeds the pack budget {spec}; pass a larger spec"
                )
            if cur and (n + gn > cap_n or e + ge > cap_e or len(cur) >= cap_g
                        or t + gt > cap_t):
                groups.append(cur)
                cur, n, e, t = [], 0, 0, 0
            cur.append(int(i))
            n, e, t = n + gn, e + ge, t + gt
        if cur:
            groups.append(cur)
        return groups

    def _groups(self) -> List[List[int]]:
        key = (self.seed, self.epoch)
        if self._groups_cache is None or self._groups_cache[0] != key:
            self._groups_cache = (key, self._make_groups())
        return self._groups_cache[1]

    def _make_groups(self) -> List[List[int]]:
        idx = self._indices()
        if self.pack:
            raw = self._pack_groups(idx)
            groups = raw[:-1] if self.drop_last and len(raw) > 1 else raw
            # the count every rank agrees on: each packs its own share of
            # the shared stream, so every rank can count every other's bins
            # and the smallest count wins (under drop_last each count
            # leaves out its final, possibly sparse, bin)
            counts = [len(raw)] + [len(self._pack_groups(self._indices(h)))
                                   for h in range(self.host_count) if h != self.host_index]
            agreed = min(max(c - 1, 0) if self.drop_last else c for c in counts)
            return groups[:agreed]
        bs = self.batch_size
        n_full = len(idx) // bs
        groups = [list(idx[b * bs : (b + 1) * bs]) for b in range(n_full)]
        if len(idx) > n_full * bs and not self.drop_last:
            groups.append(list(idx[n_full * bs :]))
        return groups

    def __len__(self) -> int:
        """The epoch's batch count, the skipped ones of a resume included."""
        return len(self._groups())

    def _batches(self, groups: List[List[int]]) -> Iterator[GraphBatch]:
        for grp in groups[max(int(self.start_batch), 0):]:
            graphs = [self.graphs[i] for i in grp]
            spec = self.spec if self.pack else self.ladder.select_for(graphs)
            yield batch_graphs(graphs, spec, sort_edges=self.sort_edges)

    def __iter__(self) -> Iterator[GraphBatch]:
        # the epoch's groups are made here, on the consumer's thread, so
        # the producer and a concurrent ``len()`` share one computation
        groups = self._groups()
        if self.prefetch <= 0:
            yield from self._batches(groups)
            return
        yield from self._prefetched(groups)

    def _emit_stall_event(self, cause: str, batch_index: int) -> None:
        """The ``loader_stall`` event of a stall verdict (obs/events.py):
        which batch wedged, not just a counter. Never fails the watchdog."""
        try:
            from ..obs.events import EV_LOADER_STALL, emit

            emit(EV_LOADER_STALL, severity="error", cause=cause, source=self.source,
                 batch_index=int(batch_index), epoch=int(self.epoch))
        except Exception:  # noqa: BLE001 — observability only
            pass

    def _prefetched(self, groups: List[List[int]]) -> Iterator[GraphBatch]:
        """The bounded producer thread and the consumer's watchdog (the JAX
        package's, verdict for verdict)."""
        from ..obs.registry import registry

        _NOTSET = object()
        epoch_start = int(self.start_batch)
        p = Producer(lambda: self._batches(groups), self.prefetch, f"loader-{self.source}")
        t = p.thread
        # kept for callers checking that the thread is reaped
        self._producer_thread = t
        g_depth = registry().gauge("hydragnn_loader_prefetch_depth",
                                   "Prefetch queue depth observed at each batch handoff",
                                   labelnames=("source",))
        c_stall = registry().counter("hydragnn_loader_stalls_total",
                                     "LoaderStallError raised (dead or wedged prefetch producer)",
                                     labelnames=("source",))
        c_stall.inc(0, source=self.source)  # the series exists from 0
        timeout = self.stall_timeout
        delivered = 0
        try:
            while True:
                # a timed wait with a liveness check instead of a bare get:
                # a dead or stalled producer raises instead of hanging
                item = _NOTSET
                waited = 0.0
                while item is _NOTSET:
                    try:
                        item = p.get(timeout=_WATCHDOG_TICK_S)
                    except queue.Empty:
                        if not t.is_alive():
                            # a last item may have landed between the
                            # timeout and the liveness check
                            try:
                                item = p.get(block=False)
                                break
                            except queue.Empty:
                                c_stall.inc(source=self.source)
                                self._emit_stall_event("producer_died", epoch_start + delivered)
                                raise LoaderStallError(
                                    "prefetch producer thread exited without an end-of-epoch "
                                    f"sentinel after batch {epoch_start + delivered - 1} (epoch "
                                    f"{self.epoch}); the worker died outside python (or was "
                                    "killed) — restarting the epoch is required") from None
                        waited += _WATCHDOG_TICK_S
                        if timeout and waited >= timeout:
                            c_stall.inc(source=self.source)
                            self._emit_stall_event("producer_wedged", epoch_start + delivered)
                            raise LoaderStallError(
                                f"prefetch producer produced nothing for {waited:.1f}s "
                                f"(> loader_stall_timeout={timeout}s) while building batch "
                                f"{epoch_start + delivered} of epoch {self.epoch}; the worker "
                                "is wedged (hung fetch/filesystem?) — raise "
                                "Training.loader_stall_timeout if batches legitimately take "
                                "this long") from None
                if item is Producer.END:
                    break
                delivered += 1
                g_depth.set(p.q.qsize(), source=self.source)
                yield item
        finally:
            # an abandoned epoch (break, exception): release the producer and
            # reap it with a bounded join. A producer blocked inside a batch
            # build cannot see ``stop`` until the build ends, so it is left
            # (a daemon) with a warning rather than blocking the teardown
            if p.close(_PRODUCER_JOIN_TIMEOUT_S):
                warnings.warn(
                    f"prefetch producer thread still alive {_PRODUCER_JOIN_TIMEOUT_S}s after "
                    "the epoch was abandoned (blocked in a batch build?); leaking the daemon "
                    "thread", RuntimeWarning, stacklevel=2)

    def spec_template_batches(self) -> List[Tuple[PadSpec, GraphBatch]]:
        return spec_template_batches(self.graphs, self.ladder, sort_edges=self.sort_edges)
