from .ring_attention import ring_self_attention
from .sp import current_sp, make_sp_eval_step, make_sp_train_step, shard_sp_batch, sp_context
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Grid,
    gather_across_hosts,
    init_group,
    local_host_info,
    setup_distributed,
)
from .engine import Objective, make_mesh_eval_step, make_mesh_train_step, place_state
from .rules import Rule, RuleError, RuleTable, preset
from .rules import resolve as resolve_rules
from .routing import BranchRoutedLoader
