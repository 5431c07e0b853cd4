"""GRNND core: graph build, beam search and recall, in PyTorch."""

from repro_torch.core.draws import Draws, RecordedDraws
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex
from repro_torch.core.grnnd import (
    GRNNDConfig,
    build_graph,
    build_graph_with_stats,
    reverse_edge_round,
    update_round,
)
from repro_torch.core.pools import (
    Pool,
    Requests,
    empty_pool,
    init_random,
    insert_requests,
    merge_into,
)
from repro_torch.core.recall import brute_force_knn, recall_at_k
from repro_torch.core.search import SearchResult, default_visited_cap, medoid, search
from repro_torch.core.vecstore import PRECISIONS, VectorStore, encode, quantize_int8

__all__ = [
    "Draws",
    "RecordedDraws",
    "DynamicConfig",
    "DynamicIndex",
    "GRNNDConfig",
    "build_graph",
    "build_graph_with_stats",
    "update_round",
    "reverse_edge_round",
    "Pool",
    "Requests",
    "empty_pool",
    "init_random",
    "insert_requests",
    "merge_into",
    "SearchResult",
    "search",
    "medoid",
    "default_visited_cap",
    "brute_force_knn",
    "recall_at_k",
    "PRECISIONS",
    "VectorStore",
    "encode",
    "quantize_int8",
]
