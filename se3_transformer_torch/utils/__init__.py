from .graph import chain_adjacency
from .helpers import (
    batched_index_select, masked_mean, resolve_device, safe_norm, to_order,
)
