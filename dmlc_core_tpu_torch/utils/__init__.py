"""Core utility substrate of the PyTorch port: logging and CHECK, timers,
small helpers, concurrency primitives, device resolution.

Counterpart of ``dmlc_core_tpu/utils``, with the same exports.  It imports
no torch: :mod:`.device`, :mod:`.profiler` and the card-waiting timers do,
when they are used.
"""

from dmlc_core_tpu_torch.utils.logging import (  # noqa: F401
    Error,
    LOG,
    CHECK,
    CHECK_EQ,
    CHECK_NE,
    CHECK_LT,
    CHECK_GT,
    CHECK_LE,
    CHECK_GE,
    CHECK_NOTNULL,
    set_log_sink,
)
from dmlc_core_tpu_torch.utils.common import split_string, hash_combine  # noqa: F401
from dmlc_core_tpu_torch.utils.timer import get_time  # noqa: F401
