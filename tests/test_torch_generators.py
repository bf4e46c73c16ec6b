"""The port's dataset generators and config lint against the JAX package's,
on the CPU: every generator ported for the dataset plane (data/shaped.py,
data/synthetic.py, data/smiles.py, data/xyz2mol.py, data/descriptors.py)
gives the JAX function's arrays byte for byte (values and dtypes) on the
same seed, and ``config.lint`` classifies every committed example config as
the JAX package's lint does, but for the deliberate differences named in
``LINT_DIFFERENCES``."""

import dataclasses
import glob
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

import hydragnn_tpu.data as jdata
import hydragnn_tpu_torch.data as tdata
from hydragnn_tpu.config import lint as j_lint
from hydragnn_tpu.data import descriptors as j_desc
from hydragnn_tpu.data import shaped as j_shaped
from hydragnn_tpu.data import smiles as j_smiles
from hydragnn_tpu.data import synthetic as j_synth
from hydragnn_tpu.data import xyz2mol as j_xyz
from hydragnn_tpu_torch.config import lint as t_lint
from hydragnn_tpu_torch.data import descriptors as t_desc
from hydragnn_tpu_torch.data import shaped as t_shaped
from hydragnn_tpu_torch.data import smiles as t_smiles
from hydragnn_tpu_torch.data import synthetic as t_synth
from hydragnn_tpu_torch.data import xyz2mol as t_xyz

REPO = Path(__file__).resolve().parents[1]


def _equal(a, b, where=""):
    """Two values hold the same bytes: arrays by dtype, shape and bits,
    containers member by member."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, (where, a, b)


SHAPED = ["ani1x_shaped_dataset", "transition1x_shaped_dataset", "qm7x_shaped_dataset",
          "omol25_shaped_dataset", "periodic_crystal_shaped_dataset",
          "alexandria_shaped_dataset", "omat24_shaped_dataset", "odac23_shaped_dataset",
          "eam_bulk_dataset", "uv_spectrum_shaped_dataset", "zinc_shaped_dataset"]


@pytest.mark.parametrize("name", SHAPED)
def pytest_shaped_generator_equals_jax(name):
    got = getattr(t_shaped, name)(number_configurations=6)
    want = getattr(j_shaped, name)(number_configurations=6)
    assert len(got) == len(want) == 6
    _equal(got, want, name)


@pytest.mark.parametrize("name,kw", [
    ("qm9_shaped_dataset", dict(number_configurations=24)),
    ("qm9_shaped_dataset", dict(number_configurations=8, seed=5, max_neighbours=3)),
    ("mptrj_shaped_dataset", dict(number_configurations=6)),
    ("mptrj_shaped_dataset", dict(number_configurations=4, seed=2, radius=4.0)),
    ("deterministic_graph_dataset", dict(number_configurations=12)),
    ("deterministic_graph_dataset", dict(number_configurations=6, linear_only=True, seed=3)),
])
def pytest_synthetic_generator_equals_jax(name, kw):
    _equal(getattr(t_synth, name)(**kw), getattr(j_synth, name)(**kw), name)


def pytest_geometry_helpers_equal_jax():
    for seed in range(4):
        _equal(t_synth.grow_molecule(np.random.default_rng(seed), 12 + seed),
               j_synth.grow_molecule(np.random.default_rng(seed), 12 + seed))
        args = (np.random.default_rng(seed), (2, 1, 2), [0, 1, 2], 2, bool(seed % 2), 2.0, 100)
        jargs = (np.random.default_rng(seed),) + args[1:]
        _equal(t_synth._configuration(*args), j_synth._configuration(*jargs))
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0.5]], np.float64)
    for reps in (1, 2, 3):
        _equal(t_synth.supercell_frac(basis, reps), j_synth.supercell_frac(basis, reps))


SMILES = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "C[N+](C)(C)C", "[O-]C(=O)CCl",
          "C1CC2CCC1C2", "Brc1ccc(I)cc1F", "C#N", "OC(=O)C%12CCCC%12"]


@pytest.mark.parametrize("s", SMILES)
def pytest_smiles_reader_equals_jax(s):
    _equal(t_smiles.parse_smiles(s), j_smiles.parse_smiles(s), s)
    for seed in (0, 7):
        _equal(t_smiles.smiles_to_graph(s, seed=seed), j_smiles.smiles_to_graph(s, seed=seed), s)
    _equal(t_smiles.smiles_to_graph(s, add_hydrogens=False, embed_3d=False),
           j_smiles.smiles_to_graph(s, add_hydrogens=False, embed_3d=False), s)


def pytest_smiles_generators_equal_jax():
    for seed in range(5):
        assert (t_smiles.random_drug_smiles(np.random.default_rng(seed), 3)
                == j_smiles.random_drug_smiles(np.random.default_rng(seed), 3))
    _equal(t_smiles.smiles_table_dataset(number_configurations=10),
           j_smiles.smiles_table_dataset(number_configurations=10))
    _equal(t_smiles.smiles_table_dataset(number_configurations=5, seed=3),
           j_smiles.smiles_table_dataset(number_configurations=5, seed=3))
    with pytest.raises(t_smiles.SmilesError):
        t_smiles.parse_smiles("C1CC")


def pytest_columnar_schema_check_equals_jax(tmp_path):
    graphs = t_smiles.smiles_table_dataset(number_configurations=4)
    tdata.ColumnarWriter(str(tmp_path / "now")).add(graphs).save()
    old = [dataclasses.replace(g, x=g.x[:, :5]) for g in graphs]
    tdata.ColumnarWriter(str(tmp_path / "old")).add(old).save()
    for path, want in (("now", True), ("old", False)):
        assert (t_smiles.columnar_schema_current(str(tmp_path / path))
                == j_smiles.columnar_schema_current(str(tmp_path / path)) == want)
    with pytest.raises(OSError):
        t_smiles.columnar_schema_current(str(tmp_path / "missing"))


def _molecule(seed, n):
    from hydragnn_tpu_torch.data.synthetic import grow_molecule

    rng = np.random.default_rng(seed)
    pos = grow_molecule(rng, n, lo=1.0, hi=1.6)
    z = rng.choice([1, 6, 7, 8], size=pos.shape[0], p=[0.4, 0.4, 0.1, 0.1])
    return z, pos


def _benzene():
    ang = np.arange(6) * np.pi / 3
    c = np.stack([1.39 * np.cos(ang), 1.39 * np.sin(ang), np.zeros(6)], axis=1)
    h = np.stack([2.47 * np.cos(ang), 2.47 * np.sin(ang), np.zeros(6)], axis=1)
    return np.array([6] * 6 + [1] * 6), np.concatenate([c, h])


@pytest.mark.parametrize("case", ["benzene", "grown 0", "grown 1", "grown 2"])
def pytest_xyz2mol_equals_jax(case):
    z, pos = _benzene() if case == "benzene" else _molecule(int(case[-1]), 10)
    _equal(t_xyz.connectivity(z, pos), j_xyz.connectivity(z, pos))
    _equal(t_xyz.perceive_molecule(z, pos), j_xyz.perceive_molecule(z, pos), case)
    _equal(t_xyz.xyz_to_graph(z, pos), j_xyz.xyz_to_graph(z, pos), case)
    _equal(t_xyz.resonance_structures(z, pos), j_xyz.resonance_structures(z, pos), case)
    if case == "benzene":
        assert len(t_xyz.resonance_structures(z, pos)) == 2  # the Kekule pair
        _equal(t_xyz.perceive_molecule(z, pos, charge=0), j_xyz.perceive_molecule(z, pos,
                                                                                  charge=0))


def pytest_descriptors_equal_jax():
    z = np.array([1, 6, 7, 8, 9, 26, 78, 118, 0])
    for one_hot in (True, False):
        _equal(t_desc.atomic_descriptors(z, one_hot), j_desc.atomic_descriptors(z, one_hot))
    _equal(t_desc.period_of(z), j_desc.period_of(z))
    _equal(t_desc.group_of(z), j_desc.group_of(z))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t_desc.smiles_to_graph("CC(=O)O")
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = j_desc.smiles_to_graph("CC(=O)O")  # rdkit is absent here too
    _equal(got, want)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert "rdkit unavailable" in str(tw[0].message)


def pytest_data_package_exports_the_jax_names():
    """The port's ``hydragnn_tpu_torch.data`` exports every public name the
    JAX package's does, but the one function of a module not ported
    (``normalize_rotation_pos``)."""
    missing = sorted(set(jdata.__all__) - set(dir(tdata)))
    assert missing == ["normalize_rotation_pos"]


# the lint's deliberate differences: (key path, the JAX status, the port's)
LINT_DIFFERENCES = {
    # postprocess/ (the plots) is not ported
    ("Visualization.create_plots", "handled", "not-ported"),
}


def _lint_map(lint, config):
    return {f.path: f.status for f in lint.lint_config(config)}


def pytest_lint_classifies_every_example_as_jax():
    paths = sorted(glob.glob(str(REPO / "examples" / "*" / "*.json")))
    assert len(paths) > 20
    seen = set()
    for p in paths:
        config = json.loads(Path(p).read_text())
        j, t = _lint_map(j_lint, config), _lint_map(t_lint, config)
        assert j.keys() == t.keys(), p
        for path in j:
            if j[path] != t[path]:
                assert (path, j[path], t[path]) in LINT_DIFFERENCES, (p, path, j[path], t[path])
                seen.add((path, j[path], t[path]))
        assert "unknown" not in t.values(), p
    assert seen == LINT_DIFFERENCES


def pytest_lint_names_what_the_port_has_not_ported():
    config = {"NeuralNetwork": {"Training": {"elastic": {"enabled": True},
                                             "checkpoint_backend": "orbax",
                                             "walltime_minutes": 60, "early_stopping": 1,
                                             "double_buffer": 2, "tipo": 3},
                                "Architecture": {"SyncBatchNorm": True}},
              "Mixture": {"temperature": 1.0}, "Serving": {"hot_reload": True},
              "Telemetry": {"fleet": False}}
    got = _lint_map(t_lint, config)
    for key in ("NeuralNetwork.Training.elastic", "NeuralNetwork.Training.checkpoint_backend",
                "NeuralNetwork.Training.walltime_minutes", "Mixture.temperature"):
        assert got[key] == "not-ported", key
    # the serving plane's hot reload and the fleet plane are ported
    assert got["Serving.hot_reload"] == got["Telemetry.fleet"] == "handled"
    assert got["NeuralNetwork.Training.double_buffer"] == "handled"
    assert got["NeuralNetwork.Training.early_stopping"] == "legacy"
    assert got["NeuralNetwork.Architecture.SyncBatchNorm"] == "not-applicable"
    assert got["NeuralNetwork.Training.tipo"] == "unknown"
    findings = t_lint.lint_config(config)
    assert "torch.distributed" in dict((f.path, f.message) for f in findings)[
        "NeuralNetwork.Architecture.SyncBatchNorm"]
    report = t_lint.format_report(findings)
    assert report.splitlines()[-1].startswith("summary: 1 unknown, 4 not-ported, 1 legacy, "
                                              "1 not-applicable")


def pytest_lint_cli_exit_codes(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"Verbosity": {"level": 0}}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"Verbosity": {"levle": 0}}))
    assert t_lint.main([str(good)]) == 0
    assert t_lint.main([str(bad)]) == 1
    assert t_lint.main([str(tmp_path / "missing.json")]) == 2
    (tmp_path / "list.json").write_text("[1]")
    assert t_lint.main([str(tmp_path / "list.json")]) == 2
    assert t_lint.main([]) == 2
    assert "Verbosity.levle" in capsys.readouterr().out
