"""Mesh construction helpers.

Axis conventions (used by every sharding annotation in the framework):
  data  — batch (data-parallel); gradients all-reduce across devices.
  model — hidden-unit blocks of the LSTM gate weights (tensor-parallel).

Pipeline parallelism is intentionally out of scope: the reference's nets
are 5 layers deep (SURVEY.md §2.3). Sequence parallelism for the
recurrence is also deliberately absent — an LSTM's time axis is serial;
the honest answer is batch parallelism + remat (SURVEY.md §5.7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from mgr_tpu.core.config import MeshConfig


def make_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh.

    With no config, all visible devices go on the data axis. Axis sizes
    must multiply to the device count (use
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu``
    to emulate N chips on one host for tests).
    """
    devices = list(devices if devices is not None else jax.devices())
    if cfg is None:
        cfg = MeshConfig(data=len(devices), model=1)
    want = cfg.num_devices
    if want > len(devices):
        raise ValueError(
            f"mesh {cfg.data}x{cfg.model}x{cfg.time} needs {want} devices, "
            f"have {len(devices)}"
        )
    if cfg.time > 1:
        grid = np.array(devices[:want]).reshape(
            cfg.data, cfg.model, cfg.time
        )
        return Mesh(grid, (cfg.data_axis, cfg.model_axis, cfg.time_axis))
    grid = np.array(devices[:want]).reshape(cfg.data, cfg.model)
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


def single_device_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
