"""Thin named-axis collective helpers for shard_map-style code.

Under ``jit`` + sharding annotations, XLA inserts collectives
automatically; these wrappers exist for explicit ``shard_map`` regions
(e.g. custom data-loading reductions, metrics aggregation) and to give
the comms layer a single audited surface — the counterpart of
the NCCL/MPI backend the reference never had (SURVEY.md §2.3).
"""

from __future__ import annotations

import jax


def psum(x, axis: str = "data"):
    return jax.lax.psum(x, axis_name=axis)


def pmean(x, axis: str = "data"):
    return jax.lax.pmean(x, axis_name=axis)


def all_gather(x, axis: str = "data", *, tiled: bool = True):
    return jax.lax.all_gather(x, axis_name=axis, tiled=tiled)


def ppermute_ring(x, axis: str = "data", shift: int = 1):
    """Rotate shards around the ring (ICI neighbour exchange)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis_name=axis, perm=perm)


def reduce_scatter(x, axis: str = "data"):
    return jax.lax.psum_scatter(x, axis_name=axis, tiled=True)
