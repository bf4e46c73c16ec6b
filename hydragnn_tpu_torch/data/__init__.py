from .graph import (
    Graph,
    GraphBatch,
    PadSpec,
    SpecLadder,
    batch_graphs,
    batch_graphs_np,
    graph_batch_from_np,
    sort_edges_by_receiver,
)
from .lappe import add_dataset_pe, add_graph_pe, laplacian_pe
from .neighbors import radius_graph, radius_graph_pbc
from .pipeline import (
    GraphLoader,
    MinMax,
    VariablesOfInterest,
    extract_variables,
    select_input_columns,
    spec_template_batches,
    split_dataset,
)
from .synthetic import (
    bcc_supercell,
    deterministic_graph_dataset,
    lennard_jones_dataset,
    md17_shaped_dataset,
    oc20_shaped_dataset,
)
