"""BASELINE config 4: 10k genomes served by a TWO-PROCESS ('dp','tp') mesh
with streamed query batches — the multi-host deployment at four-digit scale
(test_multihost.py proves the same path at toy sizes).

Spawns two worker processes (gloo CPU collectives, 4 virtual devices each →
one global 2x4 mesh), each of which ingests the same 10,240-genome clustered
set (host-route sketching, deterministic ids), builds a tp-row-sharded
ShardedIndex over the global mesh, and serves streamed query batches through
BOTH the dense sharded count and the sparse per-shard top-k paths. Results
are parity-checked against single-process host counting; process 0 prints
one JSON metrics line per phase.

CPU-mesh throughputs are NOT device numbers (the per-shard count is the
plain formula on the CPU); what this validates is the multi-process
product path at
BASELINE config 4's scale: sharded placement via jax.device_put on a
cross-process NamedSharding, cross-process collectives in shard_map, and
the multi-process host gather (ShardedIndex._to_host). Workers are pinned
to JAX_PLATFORMS=cpu, so they never open a GPU.

Usage: python tools/multihost_scale.py [--genomes 10240] [--queries 192]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

WORKER = r"""
import os, sys, time, json
import numpy as np
pid, n, port, genomes, queries, path, s15 = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    int(sys.argv[5]), sys.argv[6], int(sys.argv[7]))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
os.environ["NIQKI_TPU_SKETCH"] = "host"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=n, process_id=pid)
from niqki_tpu import SketchIndex, SketchParams, native
from niqki_tpu.parallel.mesh import make_mesh
from niqki_tpu.parallel.serving import ShardedIndex

def say(tag, **kw):
    if pid == 0:
        print(json.dumps({"metric": tag, **kw}), flush=True)

# --s15: the GOLDEN parameterization (F=32768) on 100 kb clustered
# genomes (dense sketches need >=100 kb records at this F) — the 10,240-row
# matrix is 1.34 GB of host int32 and each tp shard holds S=15-sized
# bit-planes (8x the per-row planes of the lF=12 run).
p = SketchParams(min_fract=0.05) if s15 else SketchParams(lF=12,
                                                          min_fract=0.05)
idx = SketchIndex(p)
t0 = time.time()
idx.insert_file_lines(path)          # host-route sketch, fof-order ids
ingest_s = time.time() - t0
assert idx.G == genomes, (idx.G, genomes)
say(("s15_" if s15 else "") + "multihost_ingest_genomes_per_s",
    value=round(idx.G / ingest_s, 1),
    unit="genomes/s", wall_s=round(ingest_s, 1), processes=n)

devs = jax.devices()
assert len(devs) == 8, devs
mesh = make_mesh(devs, dp=2, tp=4)
t0 = time.time()
srv = ShardedIndex(idx, mesh)
build_s = time.time() - t0
assert srv._kernel == "planes", srv._kernel
say(("s15_" if s15 else "") + "multihost_shard_build_s", value=round(build_s, 2), unit="s",
    Gp=srv._Gp)

# streamed query batches: every 7th genome (clustered set -> real hits)
mat = idx.matrix()
qs = np.ascontiguousarray(mat[::7][:queries]).astype(np.int32)
t0 = time.time()
counts = srv.counts(qs)
dense_s = time.time() - t0
say(("s15_" if s15 else "") + "multihost_query_per_s_dense", value=round(len(qs) / dense_s, 1),
    unit="queries/s", wall_s=round(dense_s, 2),
    note="CPU plain-formula count; validates the path, not device speed")

# sparse per-shard top-k path on the same batch
qsan = np.where((qs < 0) | (qs >= p.fingerprint_range), -3, qs)
t0 = time.time()
vals, gids, shard_cap = srv.topk_counts(qsan, 2048, p.min_score)
sparse_s = time.time() - t0
say(("s15_" if s15 else "") + "multihost_query_per_s_sparse", value=round(len(qs) / sparse_s, 1),
    unit="queries/s", wall_s=round(sparse_s, 2))

# parity: dense counts vs single-process host counting on a sample
sample = slice(0, 8)
want = native.count_eq(qs[sample], idx._stored_cached(),
                       p.fingerprint_range)
assert np.array_equal(counts[sample], want), "mesh counts != host counts"
# parity: sparse survivors reconstruct the dense hit sets
for r in range(8):
    sv = {(int(v), int(g)) for v, g in zip(vals[r], gids[r])
          if v >= p.min_score}
    dw = {(int(c), int(g)) for g, c in enumerate(want[r])
          if c >= p.min_score}
    assert sv == dw, f"sparse hits diverge on row {r}"
print(f"MULTIHOST_SCALE_OK {pid}", flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=10_240)
    ap.add_argument("--length", type=int, default=10_000)
    ap.add_argument("--s15", action="store_true",
                    help="golden S=15 config on 100 kb clustered genomes "
                         "(1.34 GB matrix at the default G)")
    ap.add_argument("--queries", type=int, default=192)
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    import bench_scale
    length = 100_000 if args.s15 and args.length == 10_000 else args.length
    path = bench_scale._synth_clustered_file(args.genomes, length,
                                             clusters=128)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import os
    import tempfile
    script = pathlib.Path(tempfile.mkdtemp()) / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + ":" + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port),
             str(args.genomes), str(args.queries), path,
             str(int(args.s15))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(REPO), env=env)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=args.timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
        print("TIMEOUT", file=sys.stderr)
        return 2
    ok = all(pr.returncode == 0 for pr in procs) and \
        "MULTIHOST_SCALE_OK 0" in outs[0] and \
        "MULTIHOST_SCALE_OK 1" in outs[1]
    for line in outs[0].splitlines():
        if line.startswith("{"):
            print(line)
    if not ok:
        print("\n".join(o[-3000:] for o in outs), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
