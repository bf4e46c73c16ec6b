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
