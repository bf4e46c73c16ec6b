from .ring_attention import ring_self_attention
from .sp import current_sp, make_sp_eval_step, make_sp_train_step, shard_sp_batch, sp_context
