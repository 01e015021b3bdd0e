"""Serving: continuous batching over bucketed batch shapes on one device."""
from .bucketing import (
    DEFAULT_BUCKETS, batch_bucket, pad_rows, select_bucket, strip_rows, validate_buckets,
)
from .engine import InferenceEngine
from .queueing import RequestQueue, ServeFuture, ServeRequest
from .residency import ModelPool, ResidentModel, module_bytes
