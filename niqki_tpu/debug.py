"""Runtime debug tracing + profiler hooks.

The reference's compile-time DEBUG_MSG macros (src/common.h:23-37, enabled
via ./configure --enable-debug=full) become a runtime switch here:

    NIQKI_TPU_DEBUG=1   engine-level trace (files, batches, timings)
    NIQKI_TPU_DEBUG=2   + per-record detail

``profile(dir)`` wraps a code region in a jax.profiler trace whose output
loads in TensorBoard/XProf — the device-side answer to the reference's
three chrono spans (src/niqki.cpp:307,363-365,386-390).
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import time

LEVEL = int(os.environ.get("NIQKI_TPU_DEBUG", "0") or "0")

# Route counters: how often each engine route ran in this process
# ("sketch:device", "count:pallas", "hits:sparse", ...). chip_smoke.py reads
# them to prove that the device paths it asked for are the ones that ran.
ROUTES: collections.Counter = collections.Counter()


def note(route: str, n: int = 1) -> None:
    ROUTES[route] += n


def dbg(msg: str, level: int = 1) -> None:
    if LEVEL >= level:
        print(f"[niqki_tpu +{time.monotonic():.3f}] {msg}",
              file=sys.stderr, flush=True)


@contextlib.contextmanager
def span(name: str, level: int = 1):
    """Time a host-side region and log it at the given debug level."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        dbg(f"{name}: {time.monotonic() - t0:.4f}s", level)


@contextlib.contextmanager
def profile(trace_dir: str | None):
    """jax.profiler trace of the region when trace_dir is set; no-op else."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
