from .loop import cast_batch_bf16, mp_cast_eval, mp_cast_model, test_model
