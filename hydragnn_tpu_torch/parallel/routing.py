"""Branch-routed data feeding for the routed (branch/mp) rule tables.

Counterpart of ``hydragnn_tpu/parallel/routing.py`` ``BranchRoutedLoader``
with one row per rank (``num_shards = 1``): the routed step's ranks are
grouped by branch, model-major (``mesh.Grid``), and rank ``g`` of a world
of ``W`` ranks takes graphs of branch ``g // (W / branch_count)`` only.
The mixture feeder (``BranchRoutedMixture``) comes with the mixture plane.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from ..data.graph import GraphBatch, SpecLadder, batch_graphs, batch_graphs_np, graph_batch_from_np


class BranchRoutedLoader:
    """Batches of one branch for this rank, in lockstep with every rank.

    ``host_count`` ranks share ``branch_count`` branches: ``R = host_count
    / branch_count`` ranks per branch, and rank ``host_index`` serves
    branch ``host_index // R`` through a ``GraphLoader`` over that
    branch's graphs, sharded over the branch's ``R`` ranks (``seed + 17
    b``, full batches of ``batch_size``). A branch smaller than the
    largest draws ``n_max`` samples with replacement under
    ``oversampling``. The epoch length is the largest over all branches,
    computed by every rank from the whole graph list, so ranks serving
    different branches agree without a collective; a rank whose branch is
    exhausted yields all-padding batches (no real graph: zero weight in
    the step). ``spec`` is one ``PadSpec`` or a ``SpecLadder``: each batch
    takes the smallest level that fits it, except over more than one rank,
    where the ladder collapses to its worst level as the reference's does
    (its stacked rows must share one shape across hosts).
    """

    def __init__(self, graphs: Sequence, batch_size: int, branch_count: int,
                 host_count: int = 1, host_index: int = 0, seed: int = 0,
                 shuffle: bool = True, sort_edges: bool = False, oversampling: bool = True,
                 spec=None):
        from ..data.pipeline import GraphLoader

        if host_count % branch_count:
            raise ValueError(f"{host_count} ranks are not divisible by {branch_count} branches")
        R = host_count // branch_count  # ranks per branch
        ids = sorted({g.dataset_id for g in graphs})
        if len(ids) != branch_count:
            raise ValueError(f"dataset ids {ids} != branch_count {branch_count}")
        by_branch = {i: [g for g in graphs if g.dataset_id == i] for i in ids}
        n_max = max(len(b) for b in by_branch.values())
        if spec is None:
            spec = SpecLadder.for_dataset(list(graphs), max(batch_size, 1), num_buckets=1)
        if not isinstance(spec, SpecLadder):
            spec = SpecLadder((spec,))
        if host_count > 1 and len(spec.specs) > 1:
            spec = SpecLadder((spec.specs[-1],))
        self.ladder = spec
        self.spec = spec.specs[-1]
        b = host_index // R
        bgraphs = by_branch[ids[b]]
        over = oversampling and len(bgraphs) < n_max
        self.loader = GraphLoader(
            bgraphs, batch_size, spec=self.spec, shuffle=shuffle, seed=seed + 17 * b,
            sort_edges=sort_edges, oversampling=over, num_samples=n_max if over else None,
            drop_last=True, host_count=R, host_index=host_index - b * R)
        self.branch = b
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.host_count = host_count
        self.host_index = host_index
        self.sort_edges = sort_edges
        self.seed = seed
        steps = []
        for i in ids:
            nb = len(by_branch[i])
            n_eff = n_max if (oversampling and nb < n_max) else nb
            steps.append((n_eff // R) // batch_size)
        self._len = max(steps)
        self._filler = None

    @property
    def epoch(self) -> int:
        return self.loader.epoch

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    @property
    def start_batch(self) -> int:
        return self.loader.start_batch

    def resume(self, epoch: int, next_batch: int) -> None:
        """Arm a mid-epoch resume at (``epoch``, ``next_batch``), as
        ``GraphLoader.resume`` does."""
        self.loader.resume(epoch, next_batch)

    def state_dict(self, next_batch: int = 0):
        return {"seed": int(self.seed), "epoch": int(self.epoch),
                "next_batch": int(next_batch), "num_batches": int(len(self))}

    def __len__(self) -> int:
        return self._len

    def filler(self) -> GraphBatch:
        """A batch of the worst spec with no real graph: masks false, edges
        and nodes parked on the dummy slots."""
        if self._filler is None:
            spec = self.spec
            arrs = batch_graphs_np([self.loader.graphs[0]], spec)
            z = {k: np.zeros_like(v) for k, v in arrs.items()}
            z["senders"] = np.full_like(arrs["senders"], spec.n_nodes - 1)
            z["receivers"] = z["senders"].copy()
            z["node_graph"] = np.full_like(arrs["node_graph"], spec.n_graphs - 1)
            self._filler = graph_batch_from_np(z)
        return self._filler

    def __iter__(self) -> Iterator[GraphBatch]:
        l = self.loader
        idx = l._local_indices()
        n_full = len(idx) // l.batch_size
        for step in range(max(int(l.start_batch), 0), len(self)):
            if step < n_full:
                graphs = [l.graphs[i] for i in idx[step * l.batch_size:(step + 1) * l.batch_size]]
                yield batch_graphs(graphs, self.ladder.select_for(graphs),
                                   sort_edges=self.sort_edges)
            else:
                yield self.filler()
