from .columnar import ColumnarDataset, ColumnarWriter
from .datasets import AbstractBaseDataset, SimplePickleDataset, SimplePickleWriter
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
from .lsms import compositional_histogram_cutoff, convert_total_energy_to_formation_gibbs
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
from .raw import finalize_graphs, load_raw_dataset
from .reference_energy import fit_reference_energies, subtract_reference_energies
from .synthetic import (
    bcc_supercell,
    deterministic_graph_dataset,
    lennard_jones_dataset,
    md17_shaped_dataset,
    oc20_shaped_dataset,
)
from .transforms import apply_dataset_transforms, descriptor_edge_dim, wants_transforms
