"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to drop to the CPU on their own, and the
chip smoke refuses to run without a GPU or outside a checkout."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import hydragnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hydragnn_tpu_torch.__path__, "hydragnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "jaxlib", "optax", "hydragnn_tpu")
             or m.startswith(("jax.", "flax.", "jaxlib.", "hydragnn_tpu.")))
print(len(names), bad)
assert len(names) >= 20, names
assert {"hydragnn_tpu_torch.train.checkpoint", "hydragnn_tpu_torch.utils.envflags",
        "hydragnn_tpu_torch.utils.preemption", "hydragnn_tpu_torch.launch",
        "hydragnn_tpu_torch.parallel.rules", "hydragnn_tpu_torch.parallel.mesh",
        "hydragnn_tpu_torch.parallel.engine", "hydragnn_tpu_torch.parallel.routing",
        "hydragnn_tpu_torch.parallel.dp", "hydragnn_tpu_torch.parallel.branch"} <= set(names), names
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def pytest_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def pytest_entry_points_raise_without_a_gpu(monkeypatch):
    from hydragnn_tpu_torch import api, device
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
    from hydragnn_tpu_torch.models import create_model
    from hydragnn_tpu_torch.serve import GraphServer
    from test_torch_serve import _config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    splits = split_dataset(oc20_shaped_dataset(8, mean_atoms=20, min_atoms=10,
                                               max_atoms=40, max_neighbours=10), 0.5)
    config, (_, _, test_loader), _ = api.prepare_data(_config(), splits)
    with pytest.raises(RuntimeError):
        create_model(config)
    model = create_model(config, device="cpu")
    with pytest.raises(RuntimeError):
        GraphServer(model, test_loader.ladder, template_graphs=test_loader.graphs)
    with pytest.raises(RuntimeError):
        api.run_server(_config(), datasets=splits)
    with pytest.raises(RuntimeError):
        api.run_prediction(_config(), datasets=splits)


@pytest.mark.parametrize("later", [
    {"Mixture": {"temperature": 1.0}},
    {"Dataset": {"bad_sample_policy": "quarantine"}},
])
def pytest_later_slices_raise_not_implemented(later):
    """What the port does not carry yet raises in ``prepare_data`` rather
    than be ignored: a ``Mixture`` section (the mixture plane) and the
    ``quarantine`` sample policy (the robustness slice)."""
    from hydragnn_tpu_torch import api
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
    from test_torch_serve import _config

    c = _config()
    for section, keys in later.items():
        c.setdefault(section, {}).update(keys)
    splits = split_dataset(oc20_shaped_dataset(8, mean_atoms=20, min_atoms=10,
                                               max_atoms=40, max_neighbours=10), 0.5)
    with pytest.raises(NotImplementedError, match="later slice"):
        api.prepare_data(c, splits)


@pytest.mark.parametrize("transform", [
    {"rotational_invariance": True},
    {"edge_features": ["lengths"]},
])
def pytest_load_time_transforms_apply_as_in_jax(transform):
    """The Dataset section's load-time transforms, which the earlier slices
    refused, now run in ``prepare_data`` on explicit datasets: the loaders
    hold the JAX package's transformed graphs, and the completed edge width
    is the JAX package's."""
    from hydragnn_tpu.api import prepare_data as j_prepare
    from hydragnn_tpu.data.transforms import apply_dataset_transforms
    from hydragnn_tpu_torch import api
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
    from test_torch_data import _assert_graphs_equal
    from test_torch_serve import _config

    c = _config()
    c["Dataset"].update(transform)
    splits = split_dataset(oc20_shaped_dataset(8, mean_atoms=20, min_atoms=10,
                                               max_atoms=40, max_neighbours=10), 0.5)
    config, loaders, _ = api.prepare_data(c, splits)
    jconfig, _, _ = j_prepare(c, splits)
    for loader, want in zip(loaders, apply_dataset_transforms(transform, *splits)):
        _assert_graphs_equal(want, loader.graphs)
    width = len(transform.get("edge_features", [])) or None
    assert config["NeuralNetwork"]["Architecture"]["edge_dim"] == \
        jconfig["NeuralNetwork"]["Architecture"]["edge_dim"] == width


def pytest_orbax_checkpoint_backend_raises_not_implemented():
    """``Training.checkpoint_backend: "orbax"`` (per-rank sharded
    checkpoint files) comes with the sharded-checkpoint slice; the JAX
    package's default ("msgpack") names the single file chain the port
    writes."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
    from test_torch_serve import _config

    splits = split_dataset(oc20_shaped_dataset(8, mean_atoms=20, min_atoms=10, max_atoms=40,
                                               max_neighbours=10), 0.5)
    c = _config()
    c["NeuralNetwork"]["Training"]["checkpoint_backend"] = "orbax"
    with pytest.raises(NotImplementedError, match="later slice"):
        update_config(c, *splits)
    c["NeuralNetwork"]["Training"]["checkpoint_backend"] = "msgpack"
    assert update_config(c, *splits)["NeuralNetwork"]["Training"]["Checkpoint"] is False


def pytest_sp_ring_over_two_ranks_raises_not_implemented(monkeypatch):
    """A GIN GPS-ring model builds, but its SP evaluation over a group of
    two ranks stops at ``shard_sp_batch``: the partition of the rest of the
    model across ranks comes with the SP-across-ranks slice."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data import PadSpec, batch_graphs, bcc_supercell, extract_variables
    from hydragnn_tpu_torch.data import VariablesOfInterest, add_dataset_pe
    from hydragnn_tpu_torch.models import create_model
    from hydragnn_tpu_torch.parallel import make_sp_eval_step

    voi = VariablesOfInterest([0], ["total"], ["graph"], [0], [1, 1, 1], [1])
    g = add_dataset_pe([extract_variables(bcc_supercell(2, 0.03, 0), voi)], 2)[0]
    arch = {"mpnn_type": "GIN", "hidden_dim": 8, "num_conv_layers": 1,
            "global_attn_engine": "GPS", "global_attn_type": "ring", "global_attn_heads": 2,
            "pe_dim": 2, "output_heads": {"graph": {"num_sharedlayers": 1,
                                                    "dim_sharedlayers": 4,
                                                    "num_headlayers": 1,
                                                    "dim_headlayers": [4]}}}
    config = update_config({
        "NeuralNetwork": {"Architecture": arch, "Training": {"batch_size": 1},
                          "Variables_of_interest": {"input_node_features": [0],
                                                    "output_names": ["total"],
                                                    "output_index": [0], "type": ["graph"]}},
        "Dataset": {"node_features": {"dim": [1, 1, 1]}, "graph_features": {"dim": [1]}},
    }, [g], [g], [g])
    model = create_model(config, device="cpu")
    batch = batch_graphs([g], PadSpec(g.num_nodes + 2, g.num_edges + 2, 2))
    two_ranks = object()
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2 if group is two_ranks else 1)
    tot, _, out = make_sp_eval_step(model, device="cpu")(batch)
    assert torch.isfinite(tot) and torch.isfinite(out["total"]).all()
    with pytest.raises(NotImplementedError, match="SP-across-ranks slice"):
        make_sp_eval_step(model, group=two_ranks, device="cpu")(batch)


def pytest_chip_smoke_fails_without_a_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def pytest_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
