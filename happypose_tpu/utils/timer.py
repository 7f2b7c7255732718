"""Timers with pause/resume + a device-sync variant.

Parity targets: /root/reference/happypose/toolbox/utils/timer.py:20-55
(`Timer`) and megapose/training/utils.py:218-266 (`CudaTimer`/`SimpleTimer`
— the JAX analog synchronizes via block_until_ready)."""

from __future__ import annotations

import datetime
import time
from typing import Optional

import jax


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.start_time: Optional[float] = None
        self.elapsed = 0.0
        self.is_running = False

    def start(self):
        self.elapsed = 0.0
        self.start_time = time.time()
        self.is_running = True
        return self

    def pause(self):
        if self.is_running:
            self.elapsed += time.time() - self.start_time
            self.is_running = False
        return datetime.timedelta(seconds=self.elapsed)

    def resume(self):
        if not self.is_running:
            self.start_time = time.time()
            self.is_running = True
        return self

    def stop(self):
        self.pause()
        return datetime.timedelta(seconds=self.elapsed)


class DeviceTimer:
    """Times device work by synchronizing on a result pytree."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.elapsed = 0.0

    def time(self, fn, *args, **kwargs):
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.time()
        out = jax.block_until_ready(fn(*args, **kwargs))
        self.elapsed += time.time() - t0
        return out
