"""Config-driven entry points: ``prepare_data``, ``run_training``,
``run_prediction`` and ``run_server`` (single host).

Counterpart of ``hydragnn_tpu/api.py``. ``run_training`` checkpoints to
``./logs/<log name>/`` (train/checkpoint.py: every save verified and
atomic, the end of the run always saved), resumes a run under
``Training.continue`` (mid-epoch after a SIGTERM stop) and wires the
rollback policy's restore. ``run_prediction`` and ``run_server`` restore
the newest verified checkpoint of the run; explicit ``variables`` (a JAX
package checkpoint tree as numpy arrays, loaded by
``bridge.load_jax_variables``) win over the disk. Every entry point runs on
the current CUDA device unless ``device`` says otherwise, and raises when
no GPU is present and none was given.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .config import get_log_name_config, load_config, update_config
from .data.graph import Graph, SpecLadder
from .data.pipeline import GraphLoader, _pack_spec, branch_sample_weights
from .device import DeviceLike, resolve_device


def _as_config(config) -> Dict[str, Any]:
    if isinstance(config, str):
        return load_config(config)
    if isinstance(config, dict):
        return config
    raise TypeError(f"config must be a dict or str path, got {type(config)}")


def wants_transforms(dataset_cfg: Dict[str, Any]) -> bool:
    """Whether the Dataset section asks for a load-time transform
    (``rotational_invariance``, ``edge_features``, ``Descriptors``)."""
    return bool(dataset_cfg.get("rotational_invariance") or dataset_cfg.get("edge_features")
                or dataset_cfg.get("Descriptors"))


def prepare_data(config, datasets: Optional[Tuple[Sequence[Graph], ...]] = None):
    """Complete the config from the data and build the loaders; returns
    ``(completed config, (train, val, test) loaders, minmax)``.

    ``datasets`` is the (train, val, test) split of model-ready graphs.
    Each split passes the sample validator of ``Dataset.bad_sample_policy``
    first, as in the JAX package. The train loader draws with replacement
    under ``Training.oversampling`` (``num_samples`` draws, default the
    split's size), weighted so every branch gets the same share of the
    draws under ``Training.balance_branch_sampling``, and takes the first
    ``num_samples`` of its shuffle otherwise; ``size_bucketed_batching``
    composes batches of like-sized graphs (the ladder simulates the same
    policy). Loading raw datasets from ``Dataset.path``, the load-time
    transforms (``wants_transforms``) and the ``Mixture`` section come with
    later slices and raise ``NotImplementedError``."""
    from .data.validate import SampleValidator
    from .models.create import conv_needs_triplets

    config = _as_config(config)
    if datasets is None:
        raise NotImplementedError(
            "prepare_data needs explicit (train, val, test) datasets; loading "
            "raw datasets from the Dataset section comes with a later slice"
        )
    if wants_transforms(config.get("Dataset", {})):
        raise NotImplementedError(
            "the Dataset section's load-time transforms (rotational_invariance, "
            "edge_features, Descriptors) come with the dataset slice of the port (a later "
            "slice)")
    if config.get("Mixture"):
        raise NotImplementedError(
            "the Mixture section (the streaming multi-source sampler and its branch loss "
            "weights) comes with the mixture plane of the port (a later slice); set "
            "Architecture.branch_loss_weights and Training.balance_branch_sampling instead")
    validator = SampleValidator(
        str(config.get("Dataset", {}).get("bad_sample_policy", "warn_skip")))
    trainset, valset, testset = (
        validator.filter(list(d), source=src)
        for d, src in zip(datasets, ("train", "val", "test")))
    config = update_config(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    arch = config["NeuralNetwork"]["Architecture"]
    batch_size = int(training["batch_size"])
    pack = bool(training.get("pack_batches", False))
    size_bucketing = bool(training.get("size_bucketed_batching", False))
    everything: List[Graph] = trainset + valset + testset
    # a conv that reads triplets (DimeNet) has them budgeted in the pad specs
    with_triplets = conv_needs_triplets(arch["mpnn_type"])
    if pack:
        # one budget over all three splits: eval reuses the train shapes
        spec = _pack_spec(everything, batch_size, with_triplets=with_triplets)
    else:
        spec = SpecLadder.for_dataset(
            everything, batch_size, num_buckets=int(training["num_pad_buckets"]),
            with_triplets=with_triplets, size_bucketing=size_bucketing,
        )
    kw = dict(spec=spec, pack=pack, size_bucketing=size_bucketing, validator=validator,
              sort_edges=bool(arch.get("use_sorted_aggregation", False)))
    balance = bool(training.get("balance_branch_sampling", False))
    sample_weights = branch_sample_weights(trainset) if balance else None
    train_loader = GraphLoader(
        trainset, batch_size, shuffle=True, seed=0, source="train",
        oversampling=bool(training.get("oversampling", False)) or balance,
        num_samples=training.get("num_samples"), sample_weights=sample_weights, **kw)
    val_loader = GraphLoader(valset, batch_size, shuffle=False, source="val", **kw)
    test_loader = GraphLoader(testset, batch_size, shuffle=False, source="test", **kw)
    return config, (train_loader, val_loader, test_loader), None


def _model(config, variables, device, seed):
    from .bridge import load_jax_variables
    from .models.create import create_model

    model = create_model(config, device=device, seed=seed)
    if variables is not None:
        load_jax_variables(model, variables)
    return model


def _resume(state, train_loader, startfrom: str, log_name: str, verbosity: int) -> None:
    """``Training.continue``: restore run ``startfrom``'s newest verified
    checkpoint into ``state`` and, when it stopped mid-epoch (a loader-state
    sidecar), arm ``train_loader`` to replay the rest of that epoch in the
    same order, unless the recipe (seed, batch count) changed: then the run
    resumes at epoch granularity, with a warning."""
    import warnings

    from .train.checkpoint import load_existing_model, load_loader_state

    load_existing_model(state, startfrom)
    ls = load_loader_state(startfrom)
    if ls is None:
        return
    recipe_ok = ls.seed == int(train_loader.seed)
    if recipe_ok:
        train_loader.resume(ls.epoch, ls.next_batch)
        # after arming: a packed loader's batch count depends on the epoch
        if ls.num_batches and ls.num_batches != len(train_loader):
            train_loader.resume(0, 0)  # disarm: a fresh epoch-0 start
            recipe_ok = False
    if not recipe_ok:
        warnings.warn(
            f"loader-state sidecar of run {startfrom!r} does not match the current "
            "loader (seed/batch-count drift); resuming at epoch granularity "
            "instead of mid-epoch", stacklevel=3)
    elif verbosity > 0:
        print(f"[{log_name}] resuming mid-epoch: replaying epoch {ls.epoch} from batch "
              f"{ls.next_batch}")


def run_training(config, datasets=None, variables=None, device: DeviceLike = None,
                 seed: int = 0):
    """Train on the train split, validating and testing every epoch:
    ``(model, state, history)``. The initial weights are ``variables`` (a
    JAX checkpoint tree), else the seeded initialization; under
    ``Training.continue`` the newest verified checkpoint of run
    ``Training.startfrom`` (default: this run) is restored over them.
    Checkpoints go to ``./logs/<log name>/``: the best validation epochs
    under ``Training.Checkpoint``, the SIGTERM stop, and the end of the
    run."""
    from .train.checkpoint import (clear_loader_state, load_existing_model, save_loader_state,
                                   save_model)
    from .train.loop import train_validate_test
    from .train.optimizer import make_optimizer
    from .train.state import LoaderState, TrainState
    from .utils import preemption

    config, (train_loader, val_loader, test_loader), _ = prepare_data(config, datasets)
    model = _model(config, variables, resolve_device(device), seed)
    training = config["NeuralNetwork"]["Training"]
    optimizer = make_optimizer(
        model, training["Optimizer"],
        freeze_conv=bool(config["NeuralNetwork"]["Architecture"].get("freeze_conv_layers", False)),
    )
    state = TrainState.create(model, optimizer)
    log_name = get_log_name_config(config)
    verbosity = config["Verbosity"].get("level", 0)
    if training.get("continue"):
        _resume(state, train_loader, training.get("startfrom") or log_name, log_name, verbosity)
    retention = int(training.get("checkpoint_retention", 0) or 0)

    def save_fn(s, e=None):
        out = save_model(s, log_name, epoch=e, retention=retention)
        # a committed save makes an older mid-epoch cursor stale; the
        # mid-epoch stop writes its own right after (loader_state_fn)
        clear_loader_state(log_name)
        return out

    def loader_state_fn(d):
        save_loader_state(LoaderState.from_dict(d), log_name)

    def restore_fn(template):
        # the rollback policy: the last verified checkpoint of this run
        return load_existing_model(template, log_name)

    state, hist = train_validate_test(
        model, state, train_loader, val_loader, test_loader, config,
        log_name=log_name, verbosity=verbosity, save_fn=save_fn, restore_fn=restore_fn,
        loader_state_fn=loader_state_fn,
    )
    # the end-of-run save, unless the SIGTERM stop has just saved this state
    if not preemption.global_stop_noted():
        final_epoch = len(hist["train"]) - 1
        save_fn(state, final_epoch if final_epoch >= 0 else None)
    return model, state, hist


def _restore_for_inference(model, config) -> str:
    """Restore the run's newest verified checkpoint into ``model`` through
    an optimizer-free ``InferenceState`` (``FileNotFoundError`` when there
    is none, the model untouched). Returns the file restored: it may be
    older than ``latest`` names, after a walk-back past a corrupt file."""
    from .train.checkpoint import load_inference_state
    from .train.state import InferenceState

    _, entry = load_inference_state(InferenceState(model), get_log_name_config(config))
    return entry


def run_prediction(config, variables=None, datasets=None, device: DeviceLike = None):
    """Evaluate on the test split: ``(loss, per-task losses, predictions,
    targets)``. The weights are ``variables`` (a JAX checkpoint tree), else
    the run's newest verified checkpoint; with neither it raises
    ``FileNotFoundError``."""
    from .train.loop import test_model

    config, (_, _, test_loader), _ = prepare_data(config, datasets)
    model = _model(config, variables, resolve_device(device), 0)
    if variables is None:
        _restore_for_inference(model, config)
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
    submit requests and ``close()`` it, or use it as a context manager).
    The weights are ``variables`` (a JAX checkpoint tree), else the run's
    newest verified checkpoint (``stats()["current_checkpoint"]`` names the
    file); with no checkpoint file on disk it warns and serves the seeded
    initialization, and with checkpoint files of which none verifies and
    loads it raises ``FileNotFoundError``."""
    import warnings

    from .serve import GraphServer, ServeConfig
    from .train.checkpoint import has_checkpoint

    config, (_, _, test_loader), _ = prepare_data(config, datasets)
    dev = resolve_device(device)
    log_name = get_log_name_config(config)
    model = _model(config, variables, dev, seed)
    entry = None
    if variables is None:
        if has_checkpoint(log_name):
            entry = _restore_for_inference(model, config)
        else:
            warnings.warn(
                f"run {log_name!r} has no checkpoint on disk; serving the fresh "
                "model initialization (train first for real predictions)",
                stacklevel=2,
            )
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
        log_name=log_name,
        checkpoint_label=entry,
    )
    return server.start()
