"""Fault tolerance (counterpart of timm_tpu/resilience): durable
checkpoints, the non-finite step sentinel, preemption-aware shutdown, host
RNG capture for mid-epoch resume, the reader retry policy and the
``sigterm@N`` fault injection. Sharded and asynchronous checkpoints, elastic
and multi-host resume wait (ROADMAP A.5.11), as do the other fault specs
(A.5.4)."""
from .durable import (
    SCHEMA_VERSION, CorruptCheckpointError, atomic_copy, atomic_write_bytes, atomic_write_json,
    atomic_write_npz, checkpoint_progress_key, find_checkpoints, load_verified, load_with_fallback,
    manifest_path, read_manifest, remove_checkpoint_files, resolve_auto_resume, verify_checkpoint,
)
from .faultinject import FaultInjector
from .hoststate import (
    DROP_RNG_KEY, RESUME_PREFIX, capture_drop_rng, capture_host_rng, restore_drop_rng,
    restore_host_rng,
)
from .preemption import GracefulShutdown, TrainingPreempted
from .sentinel import (
    NonFiniteError, NonFiniteSentinel, guard_enabled, new_sentinel_state, tree_all_finite,
    update_sentinel_state,
)
from .retry import DEFAULT_POISON_BUDGET, SkipBudget, TooManyBadSamples, backoff_delays, retry_io
