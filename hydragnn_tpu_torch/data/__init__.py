from .columnar import ColumnarDataset, ColumnarWriter
from .datasets import AbstractBaseDataset, SimplePickleDataset, SimplePickleWriter
from .ddstore import DDStore, DistDataset, MultiHostDistDataset, RemoteStoreClient
from .descriptors import atomic_descriptors, smiles_to_graph
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
from .lsms import (
    compositional_histogram_cutoff,
    compute_formation_enthalpy,
    convert_total_energy_to_formation_gibbs,
    mixing_entropy,
)
from .neighbors import edge_vectors_and_lengths, radius_graph, radius_graph_pbc
from .pipeline import (
    GraphLoader,
    LoaderStallError,
    MinMax,
    VariablesOfInterest,
    branch_sample_weights,
    extract_variables,
    select_input_columns,
    spec_template_batches,
    split_dataset,
)
from .raw import (
    finalize_graphs,
    load_cfg_file,
    load_lsms_file,
    load_raw_dataset,
    load_xyz_file,
)
from .reference_energy import fit_reference_energies, subtract_reference_energies
from .shaped import (
    alexandria_shaped_dataset,
    ani1x_shaped_dataset,
    eam_bulk_dataset,
    odac23_shaped_dataset,
    omat24_shaped_dataset,
    omol25_shaped_dataset,
    periodic_crystal_shaped_dataset,
    qm7x_shaped_dataset,
    transition1x_shaped_dataset,
    uv_spectrum_shaped_dataset,
    zinc_shaped_dataset,
)
from .smiles import parse_smiles, random_drug_smiles, smiles_table_dataset
from .synthetic import (
    bcc_supercell,
    deterministic_graph_dataset,
    lennard_jones_dataset,
    md17_shaped_dataset,
    mptrj_shaped_dataset,
    oc20_shaped_dataset,
    qm9_shaped_dataset,
)
from .transforms import (
    add_edge_lengths,
    add_point_pair_features,
    add_spherical_descriptors,
    apply_dataset_transforms,
    apply_post_edge_transforms,
    apply_pre_edge_transforms,
    descriptor_edge_dim,
    estimate_normals,
    normalize_edge_attr,
    normalize_rotation,
    wants_transforms,
)
from .validate import BadSampleError, CorruptSampleError, SampleValidator, validate_graph
from .xyz2mol import perceive_molecule, xyz_to_graph
