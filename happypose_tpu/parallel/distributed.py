"""Multi-host runtime initialization + rank helpers.

Parity target: /root/reference/happypose/toolbox/utils/distributed.py:89-153
(`init_distributed_mode`, `get_rank`, `get_world_size`) — one NCCL process
group per GPU, rendezvous through MASTER_ADDR/MASTER_PORT env vars.

Here `jax.distributed.initialize` joins the single-program SPMD runtime
(XLA issues the collectives; no process groups to manage). The
same env-var spelling is honored so launcher scripts carry over; on a
single host everything no-ops gracefully.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from happypose_tpu.utils.logging import get_logger

logger = get_logger(__name__)

_initialized = False


def init_distributed_mode(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host runtime (idempotent; single-host = no-op).

    Defaults follow the reference's env-var convention
    (distributed.py:137-141): MASTER_ADDR/MASTER_PORT name the
    coordinator, WORLD_SIZE/RANK the process layout. One process that
    drives every GPU of its host needs none of them.
    """
    global _initialized
    if _initialized:
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12345')}"
        )
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes is None or num_processes <= 1:
        logger.info("single-process run; distributed init skipped")
        _initialized = True
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    logger.info(
        f"joined distributed runtime: process {jax.process_index()}"
        f"/{jax.process_count()}, {jax.device_count()} devices"
    )


def get_rank() -> int:
    return jax.process_index()


def get_world_size() -> int:
    return jax.process_count()


def is_main_process() -> bool:
    return jax.process_index() == 0
