"""Retrieval in the decode loop: the kNN-LM datastores and their hooks."""

from repro_torch.retrieval.knn_lm import (
    DEFAULT_BUILD_CFG,
    DynamicDatastore,
    KNNDatastore,
    build_datastore,
    fuse,
    knn_logits,
    make_logit_hook,
    make_stream_hook,
    vote_log_probs,
)

__all__ = [
    "DEFAULT_BUILD_CFG",
    "DynamicDatastore",
    "KNNDatastore",
    "build_datastore",
    "fuse",
    "knn_logits",
    "make_logit_hook",
    "make_stream_hook",
    "vote_log_probs",
]
