"""The port's raw-file loaders and LSMS utilities against the JAX
package's, on the CPU: LSMS, XYZ and CFG files written with numpy from a
seed, parsed by both packages into equal graphs (bit for bit), their radius
graphs open and periodic; a truncated file skipped with a warning or
raised on; the formation Gibbs conversion and the compositional histogram
cutoff (the same files written, byte for byte); the per-element reference
energies. The test graphs stay under the JAX package's 4,096-node switch
to its native cell-list library, where both packages take the KD-tree and
give the same edges in the same order."""

import dataclasses
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hydragnn_tpu.data import lsms as jlsms
from hydragnn_tpu.data import raw as jraw
from hydragnn_tpu.data import reference_energy as jref
from hydragnn_tpu_torch.data import lsms as tlsms
from hydragnn_tpu_torch.data import oc20_shaped_dataset
from hydragnn_tpu_torch.data import raw as traw
from hydragnn_tpu_torch.data import reference_energy as tref
from test_torch_data import _assert_graphs_equal

torch.set_num_threads(2)

LSMS_COLS = dict(node_feature_cols=[0, 5, 6], node_feature_dims=[1, 1, 1],
                 graph_feature_cols=[0], graph_feature_dims=[1])


def _write_xyz(path: Path, n_files: int, seed: int, numeric_comment: bool = True):
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    symbols = ["H", "C", "N", "O", "Fe", "Pt"]
    for i in range(n_files):
        n = int(rng.integers(4, 12))
        comment = (" ".join(f"{v:.6f}" for v in rng.normal(size=2)) if numeric_comment
                   else 'Lattice="5 0 0 0 5 0 0 0 5" Properties=species:S:1:pos:R:3')
        rows = [f"{symbols[int(rng.integers(len(symbols)))]} "
                + " ".join(f"{v:.6f}" for v in rng.uniform(0, 4, size=3))
                + " " + " ".join(f"{v:.4f}" for v in rng.normal(size=2)) for _ in range(n)]
        (path / f"m{i:03d}.xyz").write_text("\n".join([str(n), comment, *rows]) + "\n")
    (path / "notes.txt").write_text("not a sample\n")


def _write_cfg(path: Path, n_files: int, seed: int, bulk: bool = True):
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    for i in range(n_files):
        counts = (int(rng.integers(2, 6)), int(rng.integers(2, 6)))
        h0 = np.diag(rng.uniform(6.0, 8.0, size=3)) + rng.normal(0, 0.1, size=(3, 3))
        lines = ["# a CFG sample", f"Number of particles = {sum(counts)}", "A = 1.0 Angstrom"]
        lines += [f"H0({a + 1},{b + 1}) = {h0[a, b]:.6f} A" for a in range(3) for b in range(3)]
        lines += [".NO_VELOCITY.", "entry_count = 4", "auxiliary[0] = c_peratom"]
        for (mass, sym), cnt in zip(((55.845, "Fe"), (195.08, "Pt")), counts):
            lines += [f"{mass}", sym]
            lines += [" ".join(f"{v:.6f}" for v in rng.uniform(0, 1, size=3))
                      + f" {rng.normal():.5f}" for _ in range(cnt)]
        (path / f"c{i:03d}.cfg").write_text("\n".join(lines) + "\n")
        if bulk:
            (path / f"c{i:03d}.bulk").write_text(f"{rng.normal():.6f} 0\n")


def _both(path, fmt, **kw):
    return (jraw.load_raw_dataset(str(path), fmt, **kw),
            traw.load_raw_dataset(str(path), fmt, **kw))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("fmt", ["LSMS", "XYZ", "CFG"])
def pytest_raw_files_parse_and_connect_identically(tmp_path, fmt, periodic):
    """Each format's files through both packages' parsers and radius graphs
    (open, or periodic with a cell: CFG's own, a cubic one added to the
    others): the same graphs, field by field, bit for bit."""
    kw = {}
    if fmt == "LSMS":
        chip_smoke.write_lsms_raw(tmp_path / "raw", 12, seed=3)
        kw = dict(LSMS_COLS, charge_density_correction=True)
    elif fmt == "XYZ":
        _write_xyz(tmp_path / "raw", 6, seed=4)
    else:
        _write_cfg(tmp_path / "raw", 5, seed=5)
    jg, tg = _both(tmp_path / "raw", fmt, **kw)
    _assert_graphs_equal(jg, tg)
    assert len(tg) == {"LSMS": 12, "XYZ": 6, "CFG": 5}[fmt] and tg[0].num_edges == 0
    if periodic and fmt != "CFG":
        cell = (8.0 * np.eye(3)).astype(np.float32)
        jg = [dataclasses.replace(g, cell=cell) for g in jg]
        tg = [dataclasses.replace(g, cell=cell) for g in tg]
    radius = 3.5 if fmt != "LSMS" else 7.0
    jf = jraw.finalize_graphs(jg, radius=radius, max_neighbours=8, periodic=periodic)
    tf = traw.finalize_graphs(tg, radius=radius, max_neighbours=8, periodic=periodic)
    _assert_graphs_equal(jf, tf)
    assert sum(g.num_edges for g in tf) > 0
    assert all((g.edge_shifts is not None) == periodic for g in tf)


def pytest_raw_parsers_agree_on_layouts_and_sidecars(tmp_path):
    """An extxyz metadata comment gives no graph targets; a CFG without its
    ``.bulk`` sidecar none either; LSMS's proton column gives ``z`` only
    when it is the first selected column. Both packages alike."""
    _write_xyz(tmp_path / "xyz", 3, seed=6, numeric_comment=False)
    _write_cfg(tmp_path / "cfg", 2, seed=7, bulk=False)
    chip_smoke.write_lsms_raw(tmp_path / "lsms", 4, seed=8)
    for path, fmt, kw in ((tmp_path / "xyz", "XYZ", {}), (tmp_path / "cfg", "CFG", {}),
                          (tmp_path / "lsms", "LSMS", dict(node_feature_cols=[5, 0],
                                                           node_feature_dims=[1, 1]))):
        jg, tg = _both(path, fmt, **kw)
        _assert_graphs_equal(jg, tg)
        assert all(g.graph_y is None for g in tg) == (fmt != "LSMS")
        assert all(g.z is None for g in tg) == (fmt == "LSMS")


@pytest.mark.parametrize("fmt", ["LSMS", "XYZ", "CFG"])
def pytest_truncated_raw_file_skipped_or_raised(tmp_path, fmt):
    """One truncated file among good ones: ``on_error="skip"`` drops it
    with a warning and keeps the rest (the same graphs in both packages);
    ``"raise"`` stops at it, as in the JAX package."""
    kw, path = {}, tmp_path / "raw"
    if fmt == "LSMS":
        chip_smoke.write_lsms_raw(path, 5, seed=9)
        kw = LSMS_COLS
        bad = path / "config_0002.txt"
    elif fmt == "XYZ":
        _write_xyz(path, 5, seed=9)
        bad = path / "m002.xyz"
    else:
        _write_cfg(path, 5, seed=9)
        bad = path / "c002.cfg"
    text = bad.read_text()
    bad.write_text(text[:len(text) * 2 // 3].rsplit(" ", 1)[0])
    with pytest.warns(UserWarning, match="skipping unparseable"):
        jg = jraw.load_raw_dataset(str(path), fmt, on_error="skip", **kw)
    with pytest.warns(UserWarning, match="skipping unparseable"):
        tg = traw.load_raw_dataset(str(path), fmt, on_error="skip", **kw)
    assert len(tg) == 4
    _assert_graphs_equal(jg, tg)
    with pytest.raises(Exception):
        jraw.load_raw_dataset(str(path), fmt, on_error="raise", **kw)
    with pytest.raises(Exception):
        traw.load_raw_dataset(str(path), fmt, on_error="raise", **kw)
    with pytest.raises(ValueError, match="on_error"):
        traw.load_raw_dataset(str(path), fmt, on_error="ignore")


def pytest_raw_dataset_refuses_mixed_targets(tmp_path):
    _write_xyz(tmp_path / "raw", 2, seed=10)
    _write_xyz(tmp_path / "other", 1, seed=11, numeric_comment=False)
    shutil.copy(tmp_path / "other" / "m000.xyz", tmp_path / "raw" / "z.xyz")
    for mod in (jraw, traw):
        with pytest.raises(ValueError, match="no graph targets"):
            mod.load_raw_dataset(str(tmp_path / "raw"), "XYZ")


def pytest_formation_gibbs_conversion_and_cutoff_match_jax(tmp_path):
    """``convert_total_energy_to_formation_gibbs`` (at 0 K and at 600 K)
    and ``compositional_histogram_cutoff`` in both packages on copies of
    the same LSMS files: the same statistics (exactly), the same rewritten
    files byte for byte, the same kept files; an existing output directory
    refused unless overwritten."""
    chip_smoke.write_lsms_raw(tmp_path / "src", 40, seed=12)
    for temp in (0.0, 600.0):
        out = {}
        for name, mod in (("jax", jlsms), ("port", tlsms)):
            shutil.copytree(tmp_path / "src", tmp_path / name / "raw")
            res = mod.convert_total_energy_to_formation_gibbs(
                str(tmp_path / name / "raw"), [26.0, 78.0], temperature_kelvin=temp,
                create_plots=False)
            out[name] = res
        for f in ("compositions", "total_energies", "linear_mixing_energies",
                  "formation_enthalpies", "formation_gibbs_energies"):
            np.testing.assert_array_equal(getattr(out["jax"], f), getattr(out["port"], f))
        assert out["jax"].files == out["port"].files
        for fname in out["port"].files:
            assert (Path(out["jax"].output_dir) / fname).read_bytes() == \
                (Path(out["port"].output_dir) / fname).read_bytes()
        with pytest.raises(FileExistsError):
            tlsms.convert_total_energy_to_formation_gibbs(str(tmp_path / "port" / "raw"),
                                                          [26.0, 78.0])
        kept = [mod.compositional_histogram_cutoff(out[name].output_dir, [26.0, 78.0], 3, 5,
                                                   link=False)
                for name, mod in (("jax", jlsms), ("port", tlsms))]
        assert kept[0] == kept[1] and 0 < len(kept[1]) < 40
        assert sorted(os.listdir(out["port"].output_dir + "_histogram_cutoff")) == kept[1]
        shutil.rmtree(tmp_path / "jax")
        shutil.rmtree(tmp_path / "port")
    assert tlsms.find_bin(1.0, 10) == jlsms.find_bin(1.0, 10) == 9
    assert tlsms.mixing_entropy(32, 7) == jlsms.mixing_entropy(32, 7)


@pytest.mark.parametrize("per_atom", [False, True])
def pytest_reference_energies_match_jax(per_atom):
    """The per-element least-squares fit (flat and per dataset) and the
    residual energies, on OC20-shaped graphs with energies drawn from a
    seed, equal to the JAX package's."""
    rng = np.random.default_rng(13)
    graphs = [dataclasses.replace(g, z=np.asarray(g.x[:, 0], np.int32), dataset_id=i % 2,
                                  graph_targets={"energy": rng.normal(size=1).astype(np.float32)})
              for i, g in enumerate(oc20_shaped_dataset(16, mean_atoms=10, min_atoms=5,
                                                        max_atoms=16))]
    for by_dataset in (False, True):
        jt = jref.fit_reference_energies(graphs, per_atom=per_atom, by_dataset=by_dataset)
        tt = tref.fit_reference_energies(graphs, per_atom=per_atom, by_dataset=by_dataset)
        assert jt == tt
        _assert_graphs_equal(jref.subtract_reference_energies(graphs, jt, per_atom=per_atom),
                             tref.subtract_reference_energies(graphs, tt, per_atom=per_atom))
