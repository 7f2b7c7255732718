"""Device-level profiling hooks.

The reference has only manual wall/cuda-event timers
(/root/reference/happypose/toolbox/utils/timer.py:20-55,
megapose/training/utils.py:218-266 `CudaTimer`). The jax profiler gives
full XLA-level device traces; this module packages
that as (a) a context manager for scripts and (b) a tiny `annotate`
wrapper so pipeline stages show up as named spans in the trace viewer
(xprof / tensorboard / Perfetto all read the output directory).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional, Union

import jax

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def device_trace(
    log_dir: Optional[Union[str, Path]],
) -> Iterator[None]:
    """Capture a device trace into `log_dir` (no-op when None).

    Usage:
        with device_trace(run_dir / "trace" if args.profile else None):
            train_epoch(...)
    """
    if log_dir is None:
        yield
        return
    log_dir = str(log_dir)
    logger.info(f"capturing jax profiler trace to {log_dir}")
    with jax.profiler.trace(log_dir):
        yield
    logger.info(f"trace written: {log_dir}")


def annotate(name: str):
    """Named span context for trace readability (e.g. 'render', 'coarse')."""
    return jax.profiler.TraceAnnotation(name)
