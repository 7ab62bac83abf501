"""Where the hand-written Pallas kernels run, and the shard_map contexts.

Single source of truth for "may the CTC kernel run here?". Three inputs
decide it:

  * ``MODE`` — "auto" (default), "pallas" (force), "xla" (disable);
    set via :func:`set_mode`.
  * the backend — the kernels are written for the GPU through Triton.
    "auto" selects them only when JAX's default backend is the GPU;
    forcing them anywhere else raises. Interpret mode is never chosen
    here: a caller asks for it with ``interpret=True``.
  * the sharding context — under multi-device pjit/GSPMD a
    ``pallas_call`` is a black box (operands get all-gathered), so the
    kernels are unsafe on GLOBAL arrays. Inside ``shard_map`` each
    device traces over its LOCAL shard, where they are safe again: the
    sharded train step (mgr_tpu.train.step) wraps its per-device
    loss/grad computation in :func:`shard_local`, which flips a
    trace-time context flag consulted here.
"""

from __future__ import annotations

import contextlib
import contextvars

import jax

MODE = "auto"

_SHARD_LOCAL = contextvars.ContextVar("mgr_tpu_shard_local", default=False)
_DIR_SHARD_AXIS = contextvars.ContextVar("mgr_tpu_direction_shard_axis",
                                         default=None)


def set_mode(mode: str) -> None:
    """Set the kernel backend: "auto" | "pallas" | "xla"."""
    global MODE
    if mode not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown kernel backend {mode!r}")
    MODE = mode


@contextlib.contextmanager
def shard_local():
    """Trace-time marker: code inside runs per-device (shard_map body),
    so the kernels see local shards and may engage even when the global
    device count is > 1."""
    token = _SHARD_LOCAL.set(True)
    try:
        yield
    finally:
        _SHARD_LOCAL.reset(token)


def in_shard_local() -> bool:
    return _SHARD_LOCAL.get()


@contextlib.contextmanager
def direction_shard(axis: str):
    """Trace-time marker: BLSTM layers inside split their two scan
    directions over mesh axis ``axis`` (size 2) — the direction-sharded
    tensor-parallel path (docs/PARALLELISM.md). Implies shard-local
    (the body runs per device under shard_map)."""
    token = _DIR_SHARD_AXIS.set(axis)
    try:
        with shard_local():
            yield
    finally:
        _DIR_SHARD_AXIS.reset(token)


def direction_shard_axis():
    """Mesh axis name when direction-sharded TP is active, else None."""
    return _DIR_SHARD_AXIS.get()


def _backend() -> str:
    return jax.default_backend()


def require_gpu() -> None:
    """Raise unless the kernels can compile here."""
    backend = _backend()
    if backend != "gpu":
        raise RuntimeError(
            f"the Pallas kernels compile only for the GPU (Triton route); "
            f"JAX's default backend is {backend!r}. Use the plain XLA "
            f"path here, or pass interpret=True to the kernel directly."
        )


def pallas_ok() -> bool:
    """True when the CTC kernel should run (trace-time check)."""
    if MODE == "xla":
        return False
    if MODE == "pallas":
        require_gpu()
        return True
    if _backend() != "gpu":
        return False
    return jax.device_count() == 1 or _SHARD_LOCAL.get()
