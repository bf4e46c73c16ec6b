"""Config-driven entry points: ``prepare_data``, ``run_training``,
``run_prediction`` and ``run_server``, on one process or over ranks.

Counterpart of ``hydragnn_tpu/api.py``. Each takes a config dict or the
path of a JSON file. With no explicit datasets, ``prepare_data`` loads the
``Dataset`` section's data (``_load_raw_dataset``: ``synthetic`` /
``unit_test``, ``lennard_jones``, ``pickle``, ``columnar``, ``LSMS``,
``XYZ``, ``CFG``), applies the load-time transforms, passes the sample
validator, normalizes (min-max) and selects the variables, attaches GPS's
Laplacian PE through its disk cache, and splits; explicit datasets get the
transforms and the validator per split. ``run_training`` writes the
completed config to ``./logs/<log name>/config.json`` and checkpoints
there (train/checkpoint.py: every save verified and atomic, the end of the
run always saved), resumes a run under ``Training.continue`` (mid-epoch
after a SIGTERM stop) and wires the rollback policy's restore.
``run_prediction`` and ``run_server`` restore the newest verified
checkpoint of the run; explicit ``variables`` (a JAX package checkpoint
tree as numpy arrays, loaded by ``bridge.load_jax_variables``) win over
the disk. ``run_prediction`` returns the predictions in the data's units
under ``Variables_of_interest.denormalize_output``. Every entry point runs
on the current CUDA device unless ``device`` says otherwise, and raises
when no GPU is present and none was given.

Over several ranks (``python -m hydragnn_tpu_torch.launch --nprocs N``,
torchrun, SLURM) ``run_training`` and ``run_prediction`` first join the
process group (``parallel.setup_distributed``: NCCL on the card, gloo for
``device="cpu"``). ``resolve_parallel`` reads the placement table from
``Parallel.rules`` or the legacy keys and records it under
``Parallel.resolved_rules``; each rank loads its own share of the data
(``GraphLoader(host_count, host_index)``, or ``BranchRoutedLoader`` for a
routed table), trains through the distributed step
(``parallel/engine.py``), and rank 0 alone writes the config and the
checkpoints. ``run_prediction`` evaluates each rank's share and gathers
the predictions to every rank.

The top-level ``Telemetry`` section and ``NeuralNetwork.Profile`` take
effect as in the JAX package (the observability plane, ``obs/``, wired by
``train/loop.py``); ``run_training`` also times its phases
(``utils/timers.py``), logs to ``run.log`` at a positive verbosity, prints
the parameter summary and writes ``scalars.jsonl``; ``run_prediction`` and
``run_server`` arm the tracer, the flight recorder and ``events.jsonl``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .config import get_log_name_config, load_config, save_config, update_config, voi_from_config
from .data.graph import Graph, SpecLadder
from .data.pipeline import (
    GraphLoader,
    MinMax,
    _pack_spec,
    branch_sample_weights,
    extract_variables,
    select_input_columns,
    split_dataset,
)
from .data.transforms import apply_dataset_transforms, wants_transforms
from .device import DeviceLike, resolve_device
from .utils import envflags
from .utils.ranks import is_primary, joined, rank, world_size


def _as_config(config) -> Dict[str, Any]:
    if isinstance(config, str):
        return load_config(config)
    if isinstance(config, dict):
        return config
    raise TypeError(f"config must be a dict or str path, got {type(config)}")


def _load_raw_dataset(config: Dict[str, Any]) -> List[Graph]:
    """The ``Dataset`` section's graphs, by ``Dataset.format``:
    ``synthetic`` / ``unit_test`` (the deterministic BCC fixture),
    ``lennard_jones``, ``pickle`` (``Dataset.path.total`` and
    ``Dataset.name``), ``columnar`` (read in ``Dataset.mode``), and the raw
    text formats ``LSMS`` (the column indices of ``node_features`` and
    ``graph_features``, ``charge_density_correction``), ``XYZ`` and ``CFG``,
    whose edges come from the radius graph. A raw file that fails to parse
    is skipped, unless ``Dataset.bad_sample_policy`` is ``error``."""
    ds = config.get("Dataset", {})
    arch = config["NeuralNetwork"]["Architecture"]
    fmt = ds.get("format", "synthetic")
    if fmt in ("synthetic", "unit_test"):
        from .data.synthetic import deterministic_graph_dataset

        opts = ds.get("synthetic", {})
        return deterministic_graph_dataset(
            number_configurations=opts.get("number_configurations", 300),
            linear_only=opts.get("linear_only", False),
            radius=arch.get("radius", 2.0) or 2.0,
            max_neighbours=arch.get("max_neighbours") or 100,
            seed=opts.get("seed", 97),
        )
    if fmt == "lennard_jones":
        from .data.synthetic import lennard_jones_dataset

        opts = dict(ds.get("lennard_jones", {}))
        opts.setdefault("radius", arch.get("radius", 2.5) or 2.5)
        if arch.get("max_neighbours"):
            opts.setdefault("max_neighbours", arch["max_neighbours"])
        return lennard_jones_dataset(**opts)
    if fmt == "pickle":
        from .data.datasets import SimplePickleDataset

        return list(SimplePickleDataset(ds["path"]["total"], ds["name"]))
    if fmt == "columnar":
        from .data.columnar import ColumnarDataset

        # the samples become host Graphs for the split and normalization:
        # the mode bounds the raw arrays' residency during the read only
        dataset = ColumnarDataset(ds["path"]["total"], mode=ds.get("mode", "mmap"))
        graphs = list(dataset)
        dataset.close()
        return graphs
    if fmt in ("LSMS", "XYZ", "CFG"):
        from .data.raw import finalize_graphs, load_raw_dataset

        kwargs: Dict[str, Any] = {}
        if fmt == "LSMS":
            nf, gf = ds.get("node_features", {}), ds.get("graph_features", {})
            if "column_index" in nf:
                kwargs.update(node_feature_cols=nf["column_index"], node_feature_dims=nf["dim"])
            if "column_index" in gf:
                kwargs.update(graph_feature_cols=gf["column_index"],
                              graph_feature_dims=gf["dim"])
            kwargs["charge_density_correction"] = ds.get("charge_density_correction", False)
        on_error = "raise" if ds.get("bad_sample_policy", "warn_skip") == "error" else "skip"
        raw = load_raw_dataset(ds["path"]["total"], fmt, on_error=on_error, **kwargs)
        return finalize_graphs(raw, radius=arch.get("radius", 5.0) or 5.0,
                               max_neighbours=arch.get("max_neighbours"),
                               periodic=arch.get("periodic_boundary_conditions", False))
    raise ValueError(f"unknown Dataset.format {fmt!r}")


def _ready_splits(config: Dict[str, Any], validator):
    """The raw path of ``prepare_data``: load, transform, validate (source
    ``ingest``), then under ``compute_grad_energy`` select the input columns
    (physical units: no min-max), else fit the min-max over the validated
    set, normalize (``Dataset.normalize``, default on) and extract the
    variables; GPS's PE; split (``perc_train``,
    ``compositional_stratified_splitting``). Returns the three splits and
    the min-max table (None under ``compute_grad_energy``)."""
    ds_cfg = config.get("Dataset", {})
    training = config["NeuralNetwork"]["Training"]
    arch = config["NeuralNetwork"]["Architecture"]
    raw = _load_raw_dataset(config)
    if wants_transforms(ds_cfg):
        (raw,) = apply_dataset_transforms(ds_cfg, raw)
    raw = validator.filter(raw, source="ingest")
    voi = voi_from_config(config)
    if training.get("compute_grad_energy", False):
        mm = None
        ready = [select_input_columns(g, voi) for g in raw]
    else:
        mm = MinMax.fit(raw)
        if ds_cfg.get("normalize", True):
            raw = mm.apply(raw)
        ready = [extract_variables(g, voi) for g in raw]
    if arch.get("global_attn_engine"):
        from .data.lappe import add_dataset_pe

        ready = add_dataset_pe(ready, int(arch.get("pe_dim") or 1),
                               cache=ds_cfg.get("lappe_cache", True))
    splits = split_dataset(ready, perc_train=training.get("perc_train", 0.7), seed=0,
                           stratified=ds_cfg.get("compositional_stratified_splitting", False))
    return splits, mm


def _zero_stage(training: Dict[str, Any]) -> int:
    opt = training.get("Optimizer", {})
    return int(opt.get("zero_stage", 1 if opt.get("use_zero_redundancy") else 0))


def resolve_parallel(config: Dict[str, Any]):
    """The run's placement table (``parallel/rules.py``): ``Parallel.rules``
    (a preset name or an inline table) wins, else the legacy keys
    (``Optimizer.zero_stage`` / ``use_zero_redundancy``,
    ``Training.branch_parallel``) choose a preset; conflicts and unknown
    ``Parallel`` keys raise here. The table is recorded under
    ``Parallel.resolved_rules`` and the legacy keys are brought in line
    with it (a routed table sets ``branch_parallel``; a sharding table
    raises ``zero_stage`` to the stage it implies). Idempotent."""
    from .parallel import rules

    table = rules.resolve(config)
    config.setdefault("Parallel", {})["resolved_rules"] = table.to_config()
    training = config.setdefault("NeuralNetwork", {}).setdefault("Training", {})
    if table.routed:
        training["branch_parallel"] = True
    else:
        implied = (3 if table.shards("params") else 2 if table.shards("grads")
                   else 1 if table.shards("opt_state") else 0)
        if implied > _zero_stage(training):
            training.setdefault("Optimizer", {})["zero_stage"] = implied
    return table


def prepare_data(config, datasets: Optional[Tuple[Sequence[Graph], ...]] = None):
    """Complete the config from the data and build the loaders; returns
    ``(completed config, (train, val, test) loaders, minmax)``.

    With ``datasets`` None the data comes from the ``Dataset`` section
    (``_ready_splits``; ``minmax`` is the table fitted there). Else
    ``datasets`` is the (train, val, test) split of model-ready graphs: the
    load-time transforms run over the three (one shared edge-length max)
    and each split passes the sample validator of
    ``Dataset.bad_sample_policy``; ``minmax`` is None. The train loader
    draws with replacement under ``Training.oversampling``
    (``num_samples`` draws, default the split's size), weighted so every
    branch gets the same share of the draws under
    ``Training.balance_branch_sampling``, and takes the first
    ``num_samples`` of its shuffle otherwise; ``size_bucketed_batching``
    composes batches of like-sized graphs (the ladder simulates the same
    policy). The ``Mixture`` section comes with a later slice and raises
    ``NotImplementedError``. The placement table is resolved and recorded
    (``resolve_parallel``). Inside a process group of more than one rank
    each rank's loaders hold its share (``host_count`` / ``host_index``;
    the train loader's batches full), and a routed table gives
    ``BranchRoutedLoader``s that feed each rank its branch."""
    from .data.validate import SampleValidator
    from .models.create import conv_needs_triplets

    config = _as_config(config)
    if config.get("Mixture"):
        raise NotImplementedError(
            "the Mixture section (the streaming multi-source sampler and its branch loss "
            "weights) comes with the mixture plane of the port (a later slice); set "
            "Architecture.branch_loss_weights and Training.balance_branch_sampling instead")
    ds_cfg = config.get("Dataset", {})
    validator = SampleValidator(str(ds_cfg.get("bad_sample_policy", "warn_skip")))
    if datasets is None:
        (trainset, valset, testset), mm = _ready_splits(config, validator)
    else:
        mm = None
        splits = [list(d) for d in datasets]
        if wants_transforms(ds_cfg):
            splits = apply_dataset_transforms(ds_cfg, *splits)
        trainset, valset, testset = (
            validator.filter(d, source=src) for d, src in zip(splits, ("train", "val", "test")))
    config = update_config(config, trainset, valset, testset)
    table = resolve_parallel(config)
    world, me = world_size(), rank()
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
    sort_edges = bool(arch.get("use_sorted_aggregation", False))
    if table.routed and world > 1:
        if pack:
            raise ValueError("Training.pack_batches is not supported with branch_parallel "
                             "(branch-routed rows need fixed graph counts); use num_pad_buckets")
        from .parallel.routing import BranchRoutedLoader
        from .parallel.rules import num_branches_of

        route = dict(branch_count=num_branches_of(config), host_count=world, host_index=me,
                     sort_edges=sort_edges, spec=spec)
        train_loader = BranchRoutedLoader(trainset, batch_size, seed=0, shuffle=True, **route)
        train_loader.validator = validator
        return config, (train_loader,
                        BranchRoutedLoader(valset, batch_size, shuffle=False,
                                           oversampling=False, **route),
                        BranchRoutedLoader(testset, batch_size, shuffle=False,
                                           oversampling=False, **route)), mm
    # the prefetch watchdog turns a wedged producer into LoaderStallError
    kw = dict(spec=spec, pack=pack, size_bucketing=size_bucketing, validator=validator,
              sort_edges=sort_edges, host_count=world, host_index=me,
              stall_timeout=float(training.get("loader_stall_timeout", 600.0) or 0.0))
    balance = bool(training.get("balance_branch_sampling", False))
    sample_weights = branch_sample_weights(trainset) if balance else None
    train_loader = GraphLoader(
        trainset, batch_size, shuffle=True, seed=0, source="train",
        oversampling=bool(training.get("oversampling", False)) or balance,
        num_samples=training.get("num_samples"), sample_weights=sample_weights,
        drop_last=world > 1,
        # batches built ahead in a producer thread (HYDRAGNN_NUM_WORKERS=0
        # builds them inline), as in the JAX package
        prefetch=max(envflags.env_int("HYDRAGNN_NUM_WORKERS", 2), 0), **kw)
    val_loader = GraphLoader(valset, batch_size, shuffle=False, source="val", **kw)
    test_loader = GraphLoader(testset, batch_size, shuffle=False, source="test", **kw)
    return config, (train_loader, val_loader, test_loader), mm


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
    The completed config goes to ``./logs/<log name>/config.json``, and
    the checkpoints beside it: the best validation epochs under
    ``Training.Checkpoint``, the SIGTERM stop, and the end of the run.

    Launched over several ranks it joins their process group first
    (``parallel.setup_distributed``; a failed rendezvous raises) and
    trains through the distributed step of ``parallel/engine.py`` with the
    state placed by the resolved table (ZeRO-1/2/3 by its scopes, the
    routed branch-parallel decoders), each rank on its own loaders; rank 0
    writes the config and the checkpoints, which hold the whole model, so
    a run resumes under another world size or preset. The returned model
    is this rank's (its decoder branches under a routed table). A routed
    table at a world of one rank raises."""
    from .parallel.mesh import setup_distributed
    from .train.checkpoint import (clear_loader_state, load_existing_model, save_loader_state,
                                   save_model)
    from .train.loop import train_validate_test
    from .train.optimizer import make_optimizer
    from .train.state import LoaderState, TrainState
    from .utils import preemption
    from .utils import tracer as tr
    from .utils.printing import print_model, setup_log
    from .utils.timers import Timer, print_timers
    from .utils.writer import MetricsWriter

    setup_distributed(device)
    # fresh per-run accumulators (class- and module-level state would
    # otherwise total repeated runs in one process)
    Timer.reset()
    tr.reset()
    with Timer("load_data"):
        config, (train_loader, val_loader, test_loader), _ = prepare_data(config, datasets)
    table = resolve_parallel(config)
    world = world_size()
    training = config["NeuralNetwork"]["Training"]
    if table.routed and world < 2:
        raise ValueError(
            "Training.branch_parallel requires a multibranch model and >=2 ranks (have "
            f"{world}): launch the run over the model axis's {table.model_size} ranks "
            "(python -m hydragnn_tpu_torch.launch --nprocs N)")
    log_name = get_log_name_config(config)
    # the compile plane's cache directory (train/compile_plane.py)
    from .train.compile_plane import setup_compile_cache

    setup_compile_cache(training, log_name)
    verbosity = config["Verbosity"].get("level", 0)
    if verbosity > 0:
        setup_log(log_name)
    if is_primary():
        save_config(config, log_name)
    with Timer("create_model"):
        model = _model(config, variables, resolve_device(device), seed)
    # the parameter summary (reference: print_model, model.py:289-297)
    print_model(model, verbosity=verbosity)
    optimizer = make_optimizer(
        model, training["Optimizer"],
        freeze_conv=bool(config["NeuralNetwork"]["Architecture"].get("freeze_conv_layers", False)),
    )
    state = TrainState.create(model, optimizer)
    if training.get("continue"):
        _resume(state, train_loader, training.get("startfrom") or log_name, log_name, verbosity)
    step_fn = eval_fn = None
    if joined():
        from .parallel import Grid, Objective, make_mesh_eval_step, make_mesh_train_step
        from .parallel import place_state

        grid = Grid(table.model_size if table.routed else 1)
        state = place_state(state, table, grid)
        model = state.model
        objective = Objective(bool(training.get("compute_grad_energy", False)),
                              bool(training.get("mixed_precision", False)))
        step_fn = make_mesh_train_step(objective, table, grid)
        eval_fn = make_mesh_eval_step(objective, table, grid)
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

    writer = MetricsWriter(log_name)

    def log_fn(epoch, scalars):
        # per-epoch scalars (reference: train_validate_test.py:198-205)
        writer.add_scalars({f"loss/{k}": v for k, v in scalars.items() if k != "lr"}, epoch)
        writer.add_scalar("lr", scalars.get("lr", 0.0), epoch)

    try:
        with Timer("train_validate_test"):
            state, hist = train_validate_test(
                model, state, train_loader, val_loader, test_loader, config,
                log_name=log_name, verbosity=verbosity, save_fn=save_fn, restore_fn=restore_fn,
                loader_state_fn=loader_state_fn, step_fn=step_fn, eval_fn=eval_fn,
                writer=writer, log_fn=log_fn,
            )
    finally:
        writer.close()
    # the end-of-run save, unless the SIGTERM stop has just saved this state
    if not preemption.global_stop_noted():
        final_epoch = len(hist["train"]) - 1
        save_fn(state, final_epoch if final_epoch >= 0 else None)
    print_timers(verbosity)
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


def _arm_plane(config, log_name: str):
    """The tracing plane of an inference entry point, as the JAX
    ``run_server`` arms it: ``Telemetry.trace`` installs a tracer
    (head-sampled at ``trace_sample``) writing ``./logs/<log_name>/trace.jsonl``;
    ``Telemetry.trace`` or ``enabled`` attaches ``events.jsonl`` and, under
    ``flight_recorder``, installs the flight recorder. Returns ``(tracer,
    flight recorder, events attached)``, the first two None when off."""
    import os

    from .obs.telemetry import resolve_telemetry

    obs_settings = resolve_telemetry(config)
    run_dir = os.path.join("./logs", log_name)
    tracer = flight = None
    if obs_settings["trace"]:
        from .obs import trace as obs_trace

        tracer = obs_trace.install(obs_trace.Tracer(
            run_dir, sample=float(obs_settings["trace_sample"])))
    armed = obs_settings["trace"] or obs_settings["enabled"]
    if armed:
        from .obs.events import attach_stream

        if obs_settings["flight_recorder"]:
            from .obs.flightrec import FlightRecorder

            flight = FlightRecorder(run_dir, tracer=tracer).install()
        attach_stream(run_dir)
    return tracer, flight, armed


def _disarm_plane(tracer, flight, armed: bool) -> None:
    """Tear down what ``_arm_plane`` installed."""
    from .obs import trace as obs_trace
    from .obs.events import detach_stream

    if flight is not None:
        flight.uninstall()
    if tracer is not None:
        obs_trace.uninstall(tracer)
        tracer.close()
    if armed:
        detach_stream()


def run_prediction(config, variables=None, datasets=None, device: DeviceLike = None):
    """Evaluate on the test split: ``(loss, per-task losses, predictions,
    targets)``. The weights are ``variables`` (a JAX checkpoint tree), else
    the run's newest verified checkpoint; with neither it raises
    ``FileNotFoundError``. Under ``Variables_of_interest.denormalize_output``
    the predictions and targets of every head come back in the data's units
    (the min-max table of a run that loaded its data from the config).

    Launched over several ranks, every rank joins the process group,
    evaluates its share of the test split with the whole model, and
    returns the world's: the losses weighted by each rank's graphs, the
    predictions and targets of every rank in rank order
    (``parallel.gather_across_hosts``)."""
    from .parallel.mesh import gather_across_hosts, setup_distributed
    from .train.loop import test_model

    setup_distributed(device)
    config, (_, _, test_loader), mm = prepare_data(config, datasets)
    world = world_size()
    if not isinstance(test_loader, GraphLoader):  # a branch-routed loader: plain shares
        test_loader = GraphLoader(test_loader.graphs, test_loader.batch_size,
                                  spec=test_loader.ladder, shuffle=False, host_count=world,
                                  host_index=rank(), sort_edges=test_loader.sort_edges)
    model = _model(config, variables, resolve_device(device), 0)
    log_name = get_log_name_config(config)
    from .train.compile_plane import setup_compile_cache
    from .tune.runtime import setup_autotune

    setup_compile_cache(config["NeuralNetwork"]["Training"], log_name)
    # the kernels' tuned table before the first launch (tune/)
    setup_autotune(config, test_loader, log_name)
    tracer, flight, armed = _arm_plane(config, log_name)
    try:
        if variables is None:
            _restore_for_inference(model, config)
        training = config["NeuralNetwork"]["Training"]
        tot, tasks, preds, trues = test_model(
            model, test_loader,
            mixed_precision=bool(training.get("mixed_precision", False)),
            compute_grad_energy=bool(training.get("compute_grad_energy", False)),
        )
    except BaseException as e:
        if flight is not None and not isinstance(e, KeyboardInterrupt):
            flight.dump("predict_exception", exc=e)
        raise
    finally:
        _disarm_plane(tracer, flight, armed)
    if world > 1:
        import numpy as np

        w = float(len(test_loader._local_indices()))
        got = gather_across_hosts({"w": np.asarray([w]), "tot": np.asarray([tot * w]),
                                   **{f"task_{k}": np.asarray([v * w])
                                      for k, v in tasks.items()}})
        total = float(got["w"].sum()) or 1.0
        tot = float(got["tot"].sum() / total)
        tasks = {k: float(got[f"task_{k}"].sum() / total) for k in tasks}
        preds, trues = gather_across_hosts(preds), gather_across_hosts(trues)
    var = config["NeuralNetwork"]["Variables_of_interest"]
    if var.get("denormalize_output") and mm is not None:
        voi = voi_from_config(config)
        for name, t, idx in zip(var["output_names"], var["type"], var["output_index"]):
            if name not in preds:
                continue  # the forces head of an energy-force run replaces it
            if t == "graph":
                denorm, sl = mm.denormalize_graph, voi.graph_feature_slice(idx)
            else:
                denorm, sl = mm.denormalize_node, voi.node_feature_slice(idx)
            preds[name], trues[name] = denorm(preds[name], sl), denorm(trues[name], sl)
    return tot, tasks, preds, trues


def run_server(config, datasets=None, variables=None, device: DeviceLike = None,
               seed: int = 0, install_sigterm: bool = False):
    """Start a ``GraphServer`` over the run's pad-bucket ladder, warmed on
    the test split's template graphs, and return it (started; callers
    submit requests and ``close()`` it, or use it as a context manager).
    The weights are ``variables`` (a JAX checkpoint tree), else the run's
    newest verified checkpoint (``stats()["current_checkpoint"]`` names the
    file); with no checkpoint file on disk it warns and serves the seeded
    initialization, and with checkpoint files of which none verifies and
    loads it raises ``FileNotFoundError``. ``Serving.hot_reload`` attaches
    a ``CheckpointWatcher`` on the run's ``latest`` pointer;
    ``install_sigterm`` wires SIGTERM to a graceful drain."""
    import warnings

    from .serve import CheckpointWatcher, GraphServer, ServeConfig
    from .train.checkpoint import has_checkpoint

    config, (_, _, test_loader), _ = prepare_data(config, datasets)
    dev = resolve_device(device)
    log_name = get_log_name_config(config)
    from .train.compile_plane import setup_compile_cache

    setup_compile_cache(config["NeuralNetwork"]["Training"], log_name)
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
    serve_cfg = ServeConfig.from_config(config)
    # the server owns the tracer and the flight recorder and tears them
    # down at close()
    tracer, flight, armed = _arm_plane(config, log_name)
    try:
        server = GraphServer(
            model,
            test_loader.ladder,
            serve_cfg,
            template_graphs=test_loader.graphs,
            mixed_precision=bool(training.get("mixed_precision", False)),
            sort_edges=bool(arch.get("use_sorted_aggregation", False)),
            device=dev,
            log_name=log_name,
            checkpoint_label=entry,
            # the int8 snapshots beside the run's checkpoints: a replica
            # that finds one skips quantization and calibration
            checkpoint_dir="./logs",
            tracer=tracer,
            flight_recorder=flight,
            events_stream=armed,
        )
    except BaseException:
        _disarm_plane(tracer, flight, armed)
        raise
    server.start(install_sigterm=install_sigterm)
    if serve_cfg.hot_reload:
        server.attach_watcher(CheckpointWatcher(
            server, log_name, poll_s=serve_cfg.reload_poll_s, initial_entry=entry).start())
    return server


def run_server_fleet(config, replicas: Optional[int] = None, path: str = "./logs",
                     per_replica_env=None, wait_ready_s: Optional[float] = None,
                     device: DeviceLike = None):
    """Start a serving fleet: ``Serving.fleet_replicas`` (or ``replicas``)
    worker processes (``python -m hydragnn_tpu_torch.serve.replica``), each
    a ``run_server`` deployment on its own ephemeral port, supervised by a
    ``ReplicaManager`` (restart with backoff, flap benching, wedge
    detection, rolling reload with rollback) and fronted by its
    ``router()`` (retries, hedging, circuit breakers, the optional
    prediction cache). Replica ``i`` runs on card ``i mod count``;
    ``device="cpu"`` runs the replicas on the CPU (tests).

    ``config`` is a config dict or a JSON path whose ``Dataset`` section
    the replicas load. ``per_replica_env`` maps a 1-based replica index to
    extra environment. ``wait_ready_s`` blocks until every replica passes
    ``/readyz`` or raises; None returns at once. Returns the started
    manager: ``.router().predict(graph)`` serves, ``.close()`` drains."""
    from .serve.fleet import ReplicaManager

    manager = ReplicaManager(config, path=path, per_replica_env=per_replica_env,
                             replicas=replicas, device=device).start()
    if wait_ready_s is not None and not manager.wait_ready(timeout=float(wait_ready_s)):
        state = manager.replica_state()
        manager.close()
        raise RuntimeError(f"serving fleet failed to become ready within {wait_ready_s}s: "
                           f"{state}")
    return manager
