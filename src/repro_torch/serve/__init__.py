"""Serving: the continuous-batching ANN engine and its workers, and the LM
engine (prefill + decode with the retrieval hooks)."""

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
from repro_torch.serve.engine import ServeEngine

__all__ = [
    "AnnEngine",
    "DynamicWorker",
    "EngineConfig",
    "EngineSaturated",
    "EngineStats",
    "MutationRequest",
    "QueryRequest",
    "QueryResult",
    "ServeEngine",
    "ShardedWorker",
    "StaticWorker",
    "TraceEvent",
    "bucket_q",
    "normalize_ef",
    "percentile",
    "replay",
    "synth_trace",
]
