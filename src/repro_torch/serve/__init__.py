"""Serving: the continuous-batching ANN engine and its workers."""

from repro_torch.serve.ann_engine import (
    AnnEngine,
    DynamicWorker,
    EngineConfig,
    EngineSaturated,
    EngineStats,
    MutationRequest,
    QueryRequest,
    QueryResult,
    ShardedWorker,
    StaticWorker,
    TraceEvent,
    bucket_q,
    normalize_ef,
    percentile,
    replay,
    synth_trace,
)

__all__ = [
    "AnnEngine",
    "DynamicWorker",
    "EngineConfig",
    "EngineSaturated",
    "EngineStats",
    "MutationRequest",
    "QueryRequest",
    "QueryResult",
    "ShardedWorker",
    "StaticWorker",
    "TraceEvent",
    "bucket_q",
    "normalize_ef",
    "percentile",
    "replay",
    "synth_trace",
]
