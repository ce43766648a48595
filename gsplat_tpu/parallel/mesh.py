"""Device mesh + multi-host initialization helpers.

The reference is strictly single-process/single-GPU (SURVEY.md §2
"Distributed/parallelism inventory — explicitly absent").  Here a named-axis
``jax.sharding.Mesh`` shards splats for projection/backward and image tile
rows for compositing (the rasterizer's analogue of sequence/context
parallelism), with camera-batch data parallelism on top for training.  The
mesh follows the algorithm only: the GPUs of one host reach each other all
to all over NVLink, so no device order is preferred.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

SPLAT_AXIS = "sp"   # splats + image tile rows (all_gather / psum_scatter)
BATCH_AXIS = "dp"   # camera batch (gradient all-reduce)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (no-op when single-process).

    Reads the standard env (``JAX_COORDINATOR_ADDRESS`` etc.) when args are
    omitted; safe to call unconditionally at program start.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None:
        return
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    batch: int = 1,
    splat: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (dp, sp) mesh.  ``splat`` defaults to all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if splat is None:
        if n % batch != 0:
            raise ValueError(f"{n} devices not divisible by batch axis {batch}")
        splat = n // batch
    if batch * splat != n:
        raise ValueError(f"mesh {batch}x{splat} != {n} devices")
    arr = np.asarray(devices).reshape(batch, splat)
    return Mesh(arr, (BATCH_AXIS, SPLAT_AXIS))


def splat_mesh(num: Optional[int] = None) -> Mesh:
    """1-D mesh over the splat/tile axis only (pure render scaling)."""
    devices = jax.devices()[: (num or len(jax.devices()))]
    return Mesh(np.asarray(devices), (SPLAT_AXIS,))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
