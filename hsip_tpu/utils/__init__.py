"""Utilities: structured logging, profiling, run summaries, checkpointing.

The reference's only observability was ``print()`` (SURVEY.md §5); these add
the production layer on top: leveled diagnostic logging, ``jax.profiler``
integration, machine-readable per-run summary JSON, and resumable batch
state.
"""

from .backend import is_gpu_backend
from .logging import get_logger, set_log_level
from .profiling import StageTimes, profile_trace, start_profiler_server
from .summary import RunSummary
from .checkpoint import BatchCheckpoint
from .xla_cache import enable_persistent_compilation_cache

__all__ = [
    "enable_persistent_compilation_cache",
    "is_gpu_backend",
    "get_logger",
    "set_log_level",
    "profile_trace",
    "start_profiler_server",
    "StageTimes",
    "RunSummary",
    "BatchCheckpoint",
]
