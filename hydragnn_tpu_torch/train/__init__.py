from .checkpoint import (
    clear_loader_state,
    latest_checkpoint_entry,
    load_existing_model,
    load_inference_entry,
    load_inference_state,
    load_loader_state,
    save_loader_state,
    save_model,
)
from .guard import NonFinitePolicy, guarded_update, step_ok
from .loop import (
    BestCheckpoint,
    EarlyStopping,
    cast_batch_bf16,
    evaluate,
    make_eval_step,
    make_train_step,
    mp_cast_eval,
    mp_cast_model,
    test_model,
    train_epoch,
    train_validate_test,
)
from .loss import compute_loss, energy_force_loss, predict_energy_forces
from .optimizer import ReduceLROnPlateau, clip_grad_norm, make_optimizer, optimizer_step
from .state import InferenceState, LoaderState, TrainState, cast_inference_weights
