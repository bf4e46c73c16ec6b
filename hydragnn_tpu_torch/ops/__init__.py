from .fused_edge import reference_edge_message_sum
from .radial import edge_vectors
from .segment import (
    fused_edge_message_sum,
    masked_global_mean_pool,
    segment_count,
    segment_mean,
    segment_sum,
)
from .sorted_segment import sorted_segment_sum, sorted_segment_sum_plain


def launch_counts():
    """``{wrapper name: {case: launches}}`` of every hand-written kernel's
    wrapper in this process: the calls that launched it plus the launches
    CUDA graph replays made (train/compile_plane.py). A serving replica's
    ``/stats`` carries it (serve/replica.py)."""
    import collections

    from .flash_attention import flash_block_summary, flash_self_attention
    from .fused_edge import fused_edge_message_sum as fused_edge
    from .multi_agg import fused_multi_agg
    from .numerics_stats import numerics_stats
    from .sorted_segment import sorted_segment_sum as segment

    return {w.__name__: dict(collections.Counter(w.launches_by_case) + w.replayed_by_case)
            for w in (segment, fused_edge, fused_multi_agg, flash_self_attention,
                      flash_block_summary, numerics_stats)}
