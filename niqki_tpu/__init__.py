"""niqki_tpu — a genome-sketch similarity search engine on JAX.

Sketching is vectorized hashing plus a per-slot min on device, the inverted
index is a dense (G, F) fingerprint matrix kept as bit-planes in device
memory, and query/all-vs-all intersection counting runs as blocked
equality-count reductions (a Pallas kernel on the GPU), sharded over device
meshes with jax collectives. Output-compatible with NIQKI (bit-for-bit on
its golden data).
"""

import os as _os

_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """The persistent compilation cache: $JAX_COMPILATION_CACHE_DIR when it
    is set, else a fixed directory inside the checkout (``.jax_cache``,
    git-ignored). A fixed path matters: the path is part of the cache key,
    so a directory that moves between runs never hits."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_ROOT, ".jax_cache"))


def _enable_persistent_compile_cache() -> None:
    """Point JAX at the persistent on-disk compilation cache.

    The engine's kernel set is small and static, so caching it across
    processes turns every startup after the first into a cache hit.
    Configured through env vars (read by jax.config at its own import) so
    importing niqki_tpu never imports jax — fully host-routed jobs stay
    jax-free end to end. Opt out with NIQKI_TPU_NO_COMPILE_CACHE=1.
    """
    if _os.environ.get("NIQKI_TPU_NO_COMPILE_CACHE"):
        return
    try:
        import sys as _sys
        path = compile_cache_dir()
        _os.makedirs(path, exist_ok=True)
        _os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", path)
        _os.environ.setdefault(
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
        if "jax" in _sys.modules:
            # Already imported: the env vars were read at that import, so
            # apply via config instead. Never import jax ourselves — a
            # fully host-routed job must stay jax-free.
            import jax
            jax.config.update("jax_compilation_cache_dir", path)
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:  # pragma: no cover - cache is best-effort
        pass


_enable_persistent_compile_cache()

from .params import SketchParams  # noqa: E402
from .index import SketchIndex  # noqa: E402

__version__ = "0.1.0"
__all__ = ["SketchParams", "SketchIndex"]
