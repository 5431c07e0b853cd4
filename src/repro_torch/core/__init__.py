"""GRNND core: graph build, beam search and recall, in PyTorch."""

from repro_torch.core.corpus_shard import (
    CorpusShardedIndex,
    memory_report,
    shard,
    shard_optimized,
    sharded_build,
    sharded_search,
)
from repro_torch.core.distributed import (
    corpus_sharded_search,
    distributed_search,
    make_sharded_builder,
    sharded_apply_requests,
    sharded_build_graph,
)
from repro_torch.core.draws import Draws, RecordedDraws
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex
from repro_torch.core.grnnd import (
    GRNNDConfig,
    build_graph,
    build_graph_with_stats,
    reverse_edge_round,
    update_round,
)
from repro_torch.core.labels import (
    LabelStore,
    encode_label_sets,
    encode_labels,
    filtered_brute_force,
    filtered_recall_at_k,
    predicate_fraction,
    random_query_filters,
)
from repro_torch.core.layout import OptimizedIndex, optimize
from repro_torch.core.pools import (
    Pool,
    Requests,
    empty_pool,
    init_random,
    insert_requests,
    merge_into,
)
from repro_torch.core.recall import brute_force_knn, distance_excess, pool_excess, recall_at_k
from repro_torch.core.search import (
    SearchResult,
    default_visited_cap,
    medoid,
    overfetch_ef,
    search,
)
from repro_torch.core.vecstore import (
    PLACEMENTS,
    PRECISIONS,
    HostTier,
    VectorStore,
    encode,
    quantize_int8,
)

__all__ = [
    "CorpusShardedIndex",
    "memory_report",
    "shard",
    "shard_optimized",
    "sharded_build",
    "sharded_search",
    "corpus_sharded_search",
    "distributed_search",
    "make_sharded_builder",
    "sharded_apply_requests",
    "sharded_build_graph",
    "Draws",
    "RecordedDraws",
    "DynamicConfig",
    "DynamicIndex",
    "GRNNDConfig",
    "build_graph",
    "build_graph_with_stats",
    "update_round",
    "reverse_edge_round",
    "LabelStore",
    "encode_labels",
    "encode_label_sets",
    "filtered_brute_force",
    "filtered_recall_at_k",
    "predicate_fraction",
    "random_query_filters",
    "OptimizedIndex",
    "optimize",
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
    "overfetch_ef",
    "brute_force_knn",
    "distance_excess",
    "pool_excess",
    "recall_at_k",
    "PLACEMENTS",
    "PRECISIONS",
    "HostTier",
    "VectorStore",
    "encode",
    "quantize_int8",
]
