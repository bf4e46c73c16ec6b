"""Config-driven entry points: ``prepare_data``, ``run_training``,
``run_prediction`` and ``run_server`` (single host).

Counterpart of ``hydragnn_tpu/api.py``. Checkpoint
restore comes with a later slice, so the model's weights come from the
caller: ``variables`` (a JAX package checkpoint tree as numpy arrays, loaded
by ``bridge.load_jax_variables``), or else the seeded fresh initialization.
Every entry point runs on the current CUDA device unless ``device`` says
otherwise, and raises when no GPU is present and none was given.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .config import get_log_name_config, load_config, update_config
from .data.graph import Graph, SpecLadder
from .data.pipeline import GraphLoader, _pack_spec
from .device import DeviceLike, resolve_device


def _as_config(config) -> Dict[str, Any]:
    if isinstance(config, str):
        return load_config(config)
    if isinstance(config, dict):
        return config
    raise TypeError(f"config must be a dict or str path, got {type(config)}")


def prepare_data(config, datasets: Optional[Tuple[Sequence[Graph], ...]] = None):
    """Complete the config from the data and build the loaders; returns
    ``(completed config, (train, val, test) loaders, minmax)``.

    ``datasets`` is the (train, val, test) split of model-ready graphs.
    Loading raw datasets from ``Dataset.path`` comes with a later slice."""
    config = _as_config(config)
    if datasets is None:
        raise NotImplementedError(
            "prepare_data needs explicit (train, val, test) datasets; loading "
            "raw datasets from the Dataset section comes with a later slice"
        )
    trainset, valset, testset = (list(d) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    arch = config["NeuralNetwork"]["Architecture"]
    batch_size = int(training["batch_size"])
    pack = bool(training.get("pack_batches", False))
    everything: List[Graph] = trainset + valset + testset
    if pack:
        # one budget over all three splits: eval reuses the train shapes
        spec = _pack_spec(everything, batch_size)
    else:
        spec = SpecLadder.for_dataset(
            everything, batch_size, num_buckets=int(training["num_pad_buckets"])
        )
    kw = dict(spec=spec, pack=pack,
              sort_edges=bool(arch.get("use_sorted_aggregation", False)))
    train_loader = GraphLoader(trainset, batch_size, shuffle=True, seed=0, **kw)
    val_loader = GraphLoader(valset, batch_size, shuffle=False, **kw)
    test_loader = GraphLoader(testset, batch_size, shuffle=False, **kw)
    return config, (train_loader, val_loader, test_loader), None


def _model(config, variables, device, seed):
    from .bridge import load_jax_variables
    from .models.create import create_model

    model = create_model(config, device=device, seed=seed)
    if variables is not None:
        load_jax_variables(model, variables)
    return model


def run_training(config, datasets=None, variables=None, device: DeviceLike = None,
                 seed: int = 0):
    """Train on the train split, validating and testing every epoch:
    ``(model, state, history)``. The initial weights are ``variables`` (a
    JAX checkpoint tree), else the seeded initialization."""
    from .train.loop import train_validate_test
    from .train.optimizer import make_optimizer
    from .train.state import TrainState

    config, (train_loader, val_loader, test_loader), _ = prepare_data(config, datasets)
    model = _model(config, variables, resolve_device(device), seed)
    training = config["NeuralNetwork"]["Training"]
    optimizer = make_optimizer(
        model, training["Optimizer"],
        freeze_conv=bool(config["NeuralNetwork"]["Architecture"].get("freeze_conv_layers", False)),
    )
    state = TrainState.create(model, optimizer)
    state, hist = train_validate_test(
        model, state, train_loader, val_loader, test_loader, config,
        log_name=get_log_name_config(config), verbosity=config["Verbosity"].get("level", 0),
    )
    return model, state, hist


def run_prediction(config, variables=None, datasets=None, device: DeviceLike = None,
                   seed: int = 0):
    """Evaluate on the test split: ``(loss, per-task losses, predictions,
    targets)``. The weights are ``variables`` (a JAX checkpoint tree),
    else the seeded initialization."""
    from .train.loop import test_model

    config, (_, _, test_loader), _ = prepare_data(config, datasets)
    model = _model(config, variables, resolve_device(device), seed)
    training = config["NeuralNetwork"]["Training"]
    return test_model(
        model, test_loader,
        mixed_precision=bool(training.get("mixed_precision", False)),
        compute_grad_energy=bool(training.get("compute_grad_energy", False)),
    )


def run_server(config, datasets=None, variables=None, device: DeviceLike = None,
               seed: int = 0):
    """Start a ``GraphServer`` over the run's pad-bucket ladder, warmed on
    the test split's template graphs, and return it (started; callers
    submit requests and ``close()`` it, or use it as a context manager)."""
    from .serve import GraphServer, ServeConfig

    config, (_, _, test_loader), _ = prepare_data(config, datasets)
    dev = resolve_device(device)
    model = _model(config, variables, dev, seed)
    training = config["NeuralNetwork"]["Training"]
    arch = config["NeuralNetwork"]["Architecture"]
    server = GraphServer(
        model,
        test_loader.ladder,
        ServeConfig.from_config(config),
        template_graphs=test_loader.graphs,
        mixed_precision=bool(training.get("mixed_precision", False)),
        sort_edges=bool(arch.get("use_sorted_aggregation", False)),
        device=dev,
        log_name=get_log_name_config(config),
    )
    return server.start()
