from .sentinel import (
    NonFiniteError, NonFiniteSentinel, guard_enabled, new_sentinel_state, tree_all_finite,
    update_sentinel_state,
)
from .retry import DEFAULT_POISON_BUDGET, SkipBudget, TooManyBadSamples, backoff_delays, retry_io
