"""The host-side graph builder (graph_builder.cpp through ctypes, with a
NumPy fallback): the port's own copy of se3_transformer_tpu/native/."""
from .loader import (
    chain_adjacency, expand_adjacency, knn_graph, native_available,
    pad_batch, pad_to_bucket,
)
