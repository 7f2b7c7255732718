"""Memory/device telemetry.

Parity target: /root/reference/happypose/toolbox/utils/resources.py:27-80
(`get_cuda_memory`/`get_gpu_memory`/`get_total_memory`, `assign_gpu`) —
mapped to the JAX runtime: device memory stats come from
`jax.local_devices()[i].memory_stats()`, process RSS from /proc.
"""

from __future__ import annotations

from typing import Dict

import jax


def get_device_memory(device_index: int = 0) -> Dict[str, float]:
    """Bytes in use / limit on a device (GiB), when the backend reports it."""
    try:
        stats = jax.local_devices()[device_index].memory_stats() or {}
    except Exception:
        stats = {}
    gib = 1024**3
    return {
        "bytes_in_use_gib": stats.get("bytes_in_use", 0) / gib,
        "peak_bytes_in_use_gib": stats.get("peak_bytes_in_use", 0) / gib,
        "bytes_limit_gib": stats.get("bytes_limit", 0) / gib,
    }


def get_total_memory() -> float:
    """This process's RSS in GiB (reference `get_total_memory`)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / (1024**2)
    except OSError:
        pass
    return 0.0


def log_memory(logger, prefix: str = "") -> None:
    dev = get_device_memory()
    logger.info(
        f"{prefix}device={dev['bytes_in_use_gib']:.2f}GiB "
        f"(peak {dev['peak_bytes_in_use_gib']:.2f}) host_rss="
        f"{get_total_memory():.2f}GiB"
    )
