"""Multi-host runtime: process initialization and preemption-safe habits.

The reference is a single `python script.py` process with no failure
handling beyond a resume prompt (SURVEY.md §5.3). Here:

  * `initialize()` wires `jax.distributed.initialize` from the standard
    env (JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) so the
    same train script runs on one host or many unchanged.
  * checkpoints are written atomically by the primary only
    (mgr_tpu.core.checkpoint uses tmp+rename), and `fit(resume=True)`
    restarts from the latest slot after a preemption.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

# Set by initialize() once it brings the client up; checked before the
# private-API probe below so a repeat initialize() in the same process
# stays a no-op even if a JAX upgrade moves jax._src.distributed
# (ADVICE r2). The probe remains for clusters initialized externally.
_initialized = False


def _distributed_client_up() -> bool:
    """Whether jax.distributed is already initialized — WITHOUT touching
    the backend. (`jax.process_count()` would initialize XLA, after
    which `jax.distributed.initialize` permanently fails — the same
    probe-before-configure trap as configuring a platform late.)"""
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:
        return False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Idempotent jax.distributed bring-up. No-op for single-process
    runs (no coordinator configured)."""
    global _initialized
    if _initialized or _distributed_client_up():
        return  # already initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True


def is_primary() -> bool:
    return jax.process_index() == 0


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
