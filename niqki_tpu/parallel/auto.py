"""Production mesh activation for the engine surface.

The reference is one process with OpenMP threads (its whole control flow is
/root/reference/src/niqki.cpp:229-456); this engine instead runs every
batch axis over a ('dp', 'tp') jax.sharding.Mesh. This module decides
*when* the product surface (SketchIndex / engine / CLI) uses that mesh:

  NIQKI_TPU_MESH = "auto"   (default) several accelerator devices (e.g. the
                            four GPUs of one host) -> default ('dp','tp')
                            shape; one device or the CPU backend -> off
                   "DxT"    explicit shape, any backend (e.g. "2x4" on the
                            8-virtual-device CPU mesh used by tests/CI)
                   "off"    force single-device paths

The CLI exposes the same choice as --mesh. A cached Mesh is process-global:
sharded sketch dispatch, ShardedIndex serving, and the ingest step all build
against the same device grid.
"""

from __future__ import annotations

import os

import jax

from .mesh import default_mesh_shape, make_mesh

_cache: dict = {}


def mesh_spec() -> str:
    return os.environ.get("NIQKI_TPU_MESH", "auto").strip().lower()


def active_mesh():
    """The production mesh, or None for single-device execution."""
    spec = mesh_spec()
    key = (spec, jax.device_count())
    if key in _cache:
        return _cache[key]
    mesh = None
    if spec in ("auto", ""):
        devs = jax.devices()
        if len(devs) > 1 and devs[0].platform != "cpu":
            dp, tp = default_mesh_shape(len(devs))
            mesh = make_mesh(devs, dp=dp, tp=tp)
    elif spec in ("off", "none", "0", "1", "1x1"):
        mesh = None
    else:
        try:
            dp_s, tp_s = spec.split("x")
            dp, tp = int(dp_s), int(tp_s)
        except ValueError as e:
            raise ValueError(
                f"NIQKI_TPU_MESH must be 'auto', 'off' or 'DxT', got {spec!r}"
            ) from e
        mesh = make_mesh(jax.devices()[: dp * tp], dp=dp, tp=tp)
    _cache[key] = mesh
    return mesh
