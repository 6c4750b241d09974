"""True multi-process (multi-host) validation of the sharded query path.

Spawns two worker processes that jax.distributed.initialize against each
other, build one global ('dp','tp') mesh over 2x4 virtual CPU devices, run
sharded_count on globally-sharded arrays, and check the gathered result
against the dense reference. This exercises exactly the code path a real
multi-host deployment runs (per-process addressable shards + cross-process
collectives); skipped if the jax build lacks multi-process CPU collectives.
The workers are pinned to the CPU backend (JAX_PLATFORMS=cpu in their
environment), so they never open a GPU, let alone the same one twice.
"""

import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=n, process_id=pid)
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils
from niqki_tpu.parallel.mesh import make_mesh
from niqki_tpu.parallel.sharded import sharded_count

devs = jax.devices()
assert len(devs) == 8, devs
mesh = make_mesh(devs, dp=2, tp=4)
rng = np.random.default_rng(0)          # identical data on every process
G, Q, F = 16, 4, 64
g = rng.integers(0, 4096, (G, F)).astype(np.int32)
q = rng.integers(0, 4096, (Q, F)).astype(np.int32)
q[1] = g[5]

def put(arr, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])

out = sharded_count(mesh)(put(q, P("dp", None)), put(g, P("tp", None)))
got = np.asarray(multihost_utils.process_allgather(out, tiled=True))
want = (q[:, None, :] == g[None, :, :]).sum(-1)
assert got.shape == want.shape and np.array_equal(got, want), \
    (got.shape, want.shape)
assert got[1, 5] == F
print(f"MULTIHOST_OK {pid}", flush=True)
"""


INGEST_WORKER = r"""
import os, sys
pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=n, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils
from niqki_tpu import oracle
from niqki_tpu.params import SketchParams
from niqki_tpu.parallel.mesh import make_mesh
from niqki_tpu.parallel.sharded import (chunk_packed, make_ingest_step_packed,
                                        shard_index)
from niqki_tpu.ops.sketch import pack_codes, EXC_PAD

devs = jax.devices()
assert len(devs) == 8, devs
mesh = make_mesh(devs, dp=2, tp=4)
p = SketchParams(lF=5, K=21)
Q, L, T, G = 4, 900, 4, 8
rng = np.random.default_rng(0)           # identical data on every process
seqs = [bytes(rng.choice(list(b"ACGTN"), L, p=[.24]*4+[.04]))
        for _ in range(Q)]
ws, nvs, es = [], [], []
for s in seqs:
    ef, er = oracle.encode_record(s, p.K)
    words, nb, exc = pack_codes(ef, er, p.K)
    cw, nv, ce = chunk_packed(words, nb, exc, T, p.K)
    ws.append(cw); nvs.append(nv); es.append(ce)
E = max(e.shape[1] for e in es)
epad = np.full((Q, T, E), EXC_PAD, np.int32)
for i, e in enumerate(es):
    epad[i, :, :e.shape[1]] = e
words = np.stack(ws); nv = np.stack(nvs).astype(np.int32)

def put(arr, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])

step = make_ingest_step_packed(p, mesh)
index = put(np.full((G, p.F), -2, np.int32), P("tp", None))
index, counts = step(put(words, P("dp", "tp", None)),
                     put(nv, P("dp", "tp")),
                     put(epad, P("dp", "tp", None)),
                     index, jnp.int32(0))
idx_host = np.asarray(multihost_utils.process_allgather(index, tiled=True))
cnt_host = np.asarray(multihost_utils.process_allgather(counts, tiled=True))
want = np.stack([
    np.where(s == -1, np.iinfo(np.int32).max, s)
    for s in (oracle.sketch_records([s], p) for s in seqs)])
assert np.array_equal(idx_host[:Q], want), "multihost ingest != oracle"
assert (idx_host[Q:] == -2).all()
want_counts = (want[:, None, :] == idx_host[None, :, :]).sum(-1)
assert np.array_equal(cnt_host, want_counts), "multihost counts != oracle"
print(f"MULTIHOST_INGEST_OK {pid}", flush=True)
"""


def _spawn_two(script_text, tmp_path, ok_tag):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(script_text)
    import os
    import pathlib
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + ":" + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=repo, env=env)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("multi-process CPU collectives hung (unsupported build)")
    if any(p.returncode != 0 for p in procs):
        joined = "\n".join(outs)
        if "gloo" in joined.lower() or "collectives" in joined.lower() \
                or "initialize" in joined.lower():
            pytest.skip(f"multi-process CPU unsupported: {joined[-400:]}")
        raise AssertionError(joined[-2000:])
    assert f"{ok_tag} 0" in outs[0]
    assert f"{ok_tag} 1" in outs[1]


def test_two_process_full_ingest_step(tmp_path):
    """The DCN-shaped path of the production ingest: packed-wire sketch +
    pmin + EP-routed insert + count across TWO real processes."""
    _spawn_two(INGEST_WORKER, tmp_path, "MULTIHOST_INGEST_OK")


def test_two_process_sharded_count(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    import os
    import pathlib
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + ":" + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=repo, env=env)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("multi-process CPU collectives hung (unsupported build)")
    if any(p.returncode != 0 for p in procs):
        joined = "\n".join(outs)
        if "gloo" in joined.lower() or "collectives" in joined.lower() \
                or "initialize" in joined.lower():
            pytest.skip(f"multi-process CPU unsupported: {joined[-400:]}")
        raise AssertionError(joined[-2000:])
    assert "MULTIHOST_OK 0" in outs[0]
    assert "MULTIHOST_OK 1" in outs[1]
