"""Device mesh construction for the sketch engine.

Two logical axes:
  * 'dp'  — data parallel: query/ingest batches shard here;
  * 'tp'  — table parallel: index genome-rows shard here (the TP analog of
            the reference's single shared bucket table), and sequence chunks
            shard here during sketching (the SP/CP analog; the per-slot min
            is a commutative monoid so a single pmin collective merges chunks,
            no ring pass needed).

Multi-host: callers run jax.distributed.initialize() first; the mesh is then
built over the global device list, and XLA compiles the collectives from the
shardings (NCCL over NVLink between the GPUs of one host).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """(dp, tp) with tp maximized among power-of-two splits: the index table
    is usually the big object, so shard it as wide as possible by default."""
    if n_devices == 1:
        return 1, 1
    dp = 2 if n_devices % 2 == 0 else 1
    return dp, n_devices // dp


def make_mesh(devices=None, dp: int | None = None, tp: int | None = None
              ) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None or tp is None:
        dp, tp = default_mesh_shape(n)
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))
