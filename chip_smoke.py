#!/usr/bin/env python3
"""Smoke run of the engine's main path on a GPU, end to end, in one process.

    python chip_smoke.py [--seed N]           one GPU: phases 1-5
    python chip_smoke.py --four [--seed N]    four GPUs: the mesh path only

Every input is synthesized from --seed (clustered point-mutants of random
ancestors, niqki_tpu/synth.py) and written as FASTA into a temporary
directory; the configuration is the CLI defaults (K=31, S=15 so F=32768,
W=12, H=4). Each phase prints one line with its result, the routes it took
and its times; any failure exits non-zero before the result line.

  1 device   a GPU backend, the card's name and power limit, the compile
             cache, the native host library (built by ``make -C native``).
  2 kernels  the bit-plane count at G=16,384 and 16,384+37, Q=128 and
             ragged, W=12 and 16: the compiled Pallas kernel against the
             plain jnp formula (exact equality, numpy on a column sample),
             both timed alone, through SketchIndex.counts and through one
             self-join block; then the tests marked ``gpu``.
  3 sketch   four 5 Mbp genomes (N runs, lowercase, a multi-record file)
             through the device sketch route, bit-for-bit against the
             native host sketcher and one genome against oracle.py.
  4 hits     `-I fof -Q qfof -J 0.05`: 16,384 genomes of 100 kb in clusters
             of 64 and 288 queries (280 mutants of indexed genomes, 8 of
             5 Mbp), against the same CLI on the native host routes.
  5 matrix   `-M` at G=4,096, J=0.05 (symmetric and full self-join sweep)
             and G=2,048, J=0 (dense self-join), against the dense host
             matrix path.

--four runs only the mesh path on the phase-4/5 inputs (NIQKI_TPU_MESH=1x4
ingest, ShardedIndex counts, sharded sparse top-k, sharded self-join)
against the host routes, and prints each device's memory in use.

The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

CHIP_SMOKE_REHEARSAL=1 JAX_PLATFORMS=cpu python chip_smoke.py [--four]
rehearses the same control flow on the CPU at tiny sizes (S=10, the Pallas
kernel interpreted; with XLA_FLAGS=--xla_force_host_platform_device_count=4
for --four) and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

REHEARSAL = bool(os.environ.get("CHIP_SMOKE_REHEARSAL"))

G_INDEX = 16384          # phase 4 index genomes
GENOME_LEN = 100_000     # phase 4/5 genome length (bacterial size cut 50x)
CLUSTER = 64             # genomes per cluster
Q_MUTANTS = 280          # phase 4 mutant queries (+ 8 long ones = 288)
LONG_LEN = 5_000_000     # phase 3 genomes and the long queries
S = 15                   # log2 F for the CLI phases (the CLI default)
F_KERNEL = 32768         # phase 2 fingerprint slots
G_M1, G_M2 = 4096, 2048  # phase 5 matrix sizes
KERNEL, KERNEL_MODE = "pallas", "bcount"
if REHEARSAL:
    G_INDEX, GENOME_LEN, LONG_LEN, S, F_KERNEL = 4160, 3000, 60_000, 10, 1024
    G_M1, G_M2 = 2112, 2048
    KERNEL, KERNEL_MODE = "pallas-interpret", "bcount-interpret"
    os.environ["NIQKI_TPU_COUNT"] = KERNEL_MODE


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def median_time(fn, reps: int = 5) -> float:
    """Median wall seconds of fn() after one warm-up call; fn must block
    until its device work is done."""
    reps = 1 if REHEARSAL else reps
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


@contextlib.contextmanager
def env(**kv):
    """Set (value str) or unset (value None) environment variables."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def routes_taken():
    """Collect the engine routes (debug.ROUTES) taken inside the block."""
    from niqki_tpu.debug import ROUTES
    before = dict(ROUTES)
    got: dict = {}
    yield got
    got.update({k: v - before.get(k, 0) for k, v in ROUTES.items()
                if v - before.get(k, 0)})


def require_routes(phase: str, got: dict, want=(), forbid=()) -> None:
    for r in want:
        check(got.get(r, 0) > 0, f"{phase}: route {r} did not run: {got}")
    for r in forbid:
        check(r not in got, f"{phase}: unrequested route {r} ran: {got}")


# every route that is not the device's own; a device phase fails on these
HOST_OR_INTERPRET = tuple(
    r for r in ("sketch:host", "count:host", "count:xla", "count:jnp",
                "count:pallas-interpret", "matrix:dense")
    if r != "count:" + KERNEL)


def cli(argv) -> float:
    """Run the CLI in this process (its report table is swallowed); return
    its wall seconds."""
    from niqki_tpu import cli as _cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = _cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} returned {rc}:\n{buf.getvalue()[-2000:]}")
    return dt


def gz_bytes(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# phase 1

def phase_device(four: bool):
    import jax
    devs = jax.devices()
    platform = devs[0].platform
    check(platform == "gpu" or REHEARSAL,
          f"device: JAX found no GPU (platform {platform!r}, {devs})")
    if four:
        check(len(devs) >= 4, f"device: --four needs 4 GPUs, found {devs}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError as e:
        check(REHEARSAL, f"device: nvidia-smi failed: {e}")
        smi = ""
    for ln in smi.splitlines():
        print(ln, flush=True)
    try:
        import niqki_tpu
        from niqki_tpu import native
    except ImportError as e:
        raise SmokeFailure(f"device: cannot import niqki_tpu ({e}); run "
                           "from the repository root") from e
    if not native.available():
        mk = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                            capture_output=True, text=True, timeout=600)
        raise SmokeFailure("device: the native host library did not build:"
                           f"\n{mk.stdout[-2000:]}\n{mk.stderr[-4000:]}")
    say("device", ok=True, platform=platform, kind=repr(devs[0].device_kind),
        count=len(devs), card=repr(smi.splitlines()[0] if smi else "?"),
        compile_cache=niqki_tpu.compile_cache_dir(), native=True)
    return devs


# ---------------------------------------------------------------------------
# phase 2

def _sanitized(a, W, fill):
    import numpy as np
    return np.where((a < 0) | (a >= 1 << W), fill, a)


def phase_kernels(rng):
    import jax
    import numpy as np
    from niqki_tpu import SketchIndex, SketchParams
    from niqki_tpu.ops import bcount
    F = F_KERNEL
    for W in (12, 16):
        G = G_INDEX + 37
        g = rng.integers(-2, 1 << W, size=(G, F), dtype=np.int32)
        rows = rng.integers(0, G, 128)
        q = g[rows].copy()
        q[:, ::3] = rng.integers(-3, 1 << W, size=q[:, ::3].shape,
                                 dtype=np.int32)
        for Gc, Qc in ((G_INDEX, 128), (G, 77)):
            gc, qc = g[:Gc], q[:Qc]
            xp = bcount.build_index_planes(gc, W)
            got = np.asarray(bcount.match_counts_planes(qc, xp, Gc, W,
                                                        KERNEL))
            plain = np.asarray(bcount.match_counts_planes(qc, xp, Gc, W,
                                                          "jnp"))
            check((got == plain).all(),
                  f"kernels: pallas != jnp at W={W} G={Gc} Q={Qc}")
            cols = rng.choice(Gc, 256, replace=False)
            gs = _sanitized(gc[cols], W, -2)
            qs = _sanitized(qc, W, -3)
            for r in range(0, Qc, 16):
                ref = (qs[r:r + 16, None, :] == gs[None]).sum(-1)
                check((got[r:r + 16, cols] == ref).all(),
                      f"kernels: pallas != numpy at W={W} G={Gc} Q={Qc}")
            msg = dict(W=W, G=Gc, Q=Qc, equal="exact(jnp,numpy-sample)")
            if Qc % bcount.TILE_Q == 0:
                # the kernel alone: resident query planes, compiled once
                qp = bcount.pack_bitplanes(jax.numpy.asarray(qc), W=W,
                                           query=True)
                comp = {i: bcount.count_planes.lower(qp, xp, impl=i)
                        .compile() for i in (KERNEL, "jnp")}
                print(f"[kernels] memory_analysis W={W} G={Gc}: "
                      f"{comp[KERNEL].memory_analysis()}", flush=True)
                for i, c in comp.items():
                    msg[f"kernel_{i}_ms"] = 1e3 * median_time(
                        lambda c=c: jax.block_until_ready(c(qp, xp)))
            # end to end: SketchIndex.counts (h2d of queries, pack, count,
            # d2h) and one self-join block, each implementation in turn
            idx = SketchIndex(SketchParams(W=W, min_fract=0.05))
            idx._mat, idx.names = gc, [f"g{i}" for i in range(Gc)]
            idx._device_planes = xp
            for mode, i in ((KERNEL_MODE, KERNEL), ("jnp", "jnp")):
                with env(NIQKI_TPU_COUNT=mode):
                    c = idx.counts(qc)
                    check((c == _counts_ref(idx, qc)).all()
                          if i == KERNEL else (c == got).all(),
                          f"kernels: SketchIndex.counts {mode} mismatch")
                    msg[f"index_counts_{i}_ms"] = 1e3 * median_time(
                        lambda: idx.counts(qc))
            if Qc == 128:
                B = bcount.MATRIX_BLOCK
                outs = {}
                for i in (KERNEL, "jnp"):
                    def block(i=i):
                        return jax.block_until_ready(bcount._self_join_topk(
                            xp, 0, idx.params.min_score, B=B, cap=1024,
                            impl=i))
                    outs[i] = [np.asarray(a) for a in block()]
                    msg[f"selfjoin_block_{i}_ms"] = 1e3 * median_time(block)
                check(all((a == b).all() for a, b in
                          zip(outs[KERNEL], outs["jnp"])),
                      "kernels: self-join block pallas != jnp")
            say("kernels", ok=True, **{k: (round(v, 3) if isinstance(
                v, float) else v) for k, v in msg.items()})
            del xp, idx
        del g, q
    _run_gpu_tests()


def _counts_ref(idx, q):
    """The native host count of q against idx (independent of the device)."""
    from niqki_tpu import native
    return native.count_eq(q, idx._stored(), idx.params.fingerprint_range)


def _run_gpu_tests():
    """The tests marked ``gpu``, in this process (one process per card)."""
    import pytest

    class Tally:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] += 1

    tally = Tally()
    t0 = time.perf_counter()
    with env(NIQKI_TPU_TEST_GPU="1"):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_bcount.py")],
                         plugins=[tally])
    check(rc == 0 and (REHEARSAL or (tally.n["passed"] > 0
                                     and not tally.n["skipped"])),
          f"kernels: gpu tests rc={rc} {tally.n}")
    say("kernels", ok=True, gpu_tests=tally.n["passed"],
        seconds=round(time.perf_counter() - t0, 1))


# ---------------------------------------------------------------------------
# phase 3

def phase_sketch(rng, tmp):
    import numpy as np
    from niqki_tpu import SketchIndex, SketchParams, oracle, synth
    from niqki_tpu.io.fasta import read_records
    p = SketchParams(lF=S)
    seqs = [synth.random_genome(rng, LONG_LEN) for _ in range(4)]
    paths = [os.path.join(tmp, f"long{i}.fa") for i in range(4)]
    synth.write_fasta(paths[0], [("messy", synth.messy(rng, seqs[0]))])
    synth.write_fasta(paths[1], [("plain", seqs[1])], line=80)
    cut = [0, LONG_LEN // 3, LONG_LEN * 5 // 8, LONG_LEN]
    synth.write_fasta(paths[2], [(f"part{j}", seqs[2][cut[j]:cut[j + 1]])
                                 for j in range(3)])
    synth.write_fasta(paths[3], [("messy2", synth.messy(rng, seqs[3], 40,
                                                        200, 0.5))], line=60)
    mbp = 4 * LONG_LEN / 1e6
    out, rates = {}, {}
    for route in ("device", "host"):
        with env(NIQKI_TPU_SKETCH=route), routes_taken() as got:
            idx = SketchIndex(p)
            idx.sketch_files(paths)            # warm: compile + page cache
            t0 = time.perf_counter()
            out[route] = idx.sketch_files(paths)
            rates[route] = mbp / (time.perf_counter() - t0)
        if route == "device":
            require_routes("sketch", got, want=["sketch:device"],
                           forbid=HOST_OR_INTERPRET)
    for a, b, path in zip(out["device"], out["host"], paths):
        check((a == b).all(), f"sketch: device != host sketch for {path}")
    recs = [s for _, s in read_records(paths[0], p.K)]
    check((out["device"][0] == oracle.sketch_records(recs, p)).all(),
          "sketch: device != oracle for the messy genome")
    say("sketch", ok=True, genomes=4, mbp=mbp, equal="exact(host,oracle)",
        route="device", device_mbp_s=round(rates["device"], 1),
        host_mbp_s=round(rates["host"], 1), slot_min="scatter-min")


# ---------------------------------------------------------------------------
# phase 4 inputs (shared with --four)

def make_hits_inputs(rng, tmp):
    """Write the G_INDEX-genome index (fof of relative names) and the
    288-query fof (absolute paths: -Q resolves from the CWD)."""
    from niqki_tpu import synth
    t0 = time.perf_counter()
    idir = os.path.join(tmp, "index")
    qdir = os.path.join(tmp, "queries")
    os.makedirs(idir)
    os.makedirs(qdir)
    src = set(int(i) for i in rng.choice(G_INDEX, Q_MUTANTS, replace=False))
    names, queries = [], []
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        futs = []
        gen = synth.clustered_genomes(rng, G_INDEX, GENOME_LEN,
                                      G_INDEX // CLUSTER)
        for i, (c, seq) in enumerate(gen):
            name = f"g{i:05d}_c{c}.fa"
            names.append(name)
            futs.append(pool.submit(synth.write_fasta,
                                    os.path.join(idir, name), [(name, seq)]))
            if i in src:
                qp = os.path.join(qdir, f"q{len(queries):03d}_of_{i}.fa")
                mut = synth.mutants(rng, seq, 1, 0.01)[0]
                futs.append(pool.submit(synth.write_fasta, qp,
                                        [(os.path.basename(qp), mut)]))
                queries.append(qp)
        for j in range(8):
            qp = os.path.join(qdir, f"long{j}.fa")
            seq = synth.random_genome(rng, LONG_LEN)
            futs.append(pool.submit(synth.write_fasta, qp,
                                    [(f"long{j}", seq)], 80))
            queries.append(qp)
        for f in futs:
            f.result()
    fof = os.path.join(idir, "fof.txt")
    synth.write_fof(fof, names)
    qfof = os.path.join(tmp, "qfof.txt")
    synth.write_fof(qfof, queries)
    fof4k = os.path.join(idir, f"fof{G_M1}.txt")
    synth.write_fof(fof4k, names[:G_M1])
    fof2k = os.path.join(idir, f"fof{G_M2}.txt")
    synth.write_fof(fof2k, names[:G_M2])
    say("inputs", ok=True, genomes=G_INDEX, genome_len=GENOME_LEN,
        queries=len(queries), gbp=round(G_INDEX * GENOME_LEN / 1e9, 3),
        seconds=round(time.perf_counter() - t0, 1))
    return fof, qfof, fof4k, fof2k


HOST_REF = dict(NIQKI_TPU_SKETCH="host", NIQKI_TPU_COUNT="host",
                NIQKI_TPU_MESH="off")


def phase_hits(tmp, fof, qfof):
    out_dev = os.path.join(tmp, "hits_device.gz")
    out_ref = os.path.join(tmp, "hits_host.gz")
    with routes_taken() as got:
        t_dev = cli(["-I", fof, "-Q", qfof, "-J", "0.05", "-S", str(S),
                     "-O", out_dev])
    require_routes("hits", got, want=["sketch:device", "count:planes-built",
                                      "hits:sparse", "count:" + KERNEL],
                   forbid=HOST_OR_INTERPRET)
    with env(**HOST_REF):
        t_ref = cli(["-I", fof, "-Q", qfof, "-J", "0.05", "-S", str(S),
                     "-O", out_ref])
    a, b = gz_bytes(out_dev), gz_bytes(out_ref)
    check(a == b, f"hits: device output ({len(a)} B) != host routes "
          f"({len(b)} B)")
    say("hits", ok=True, G=G_INDEX, Q=288, J=0.05, equal="bytes(host)",
        bytes=len(a), hit_rows=a.count(b"\n"), routes=_fmt_routes(got),
        device_s=round(t_dev, 2), host_s=round(t_ref, 2))


def _fmt_routes(got: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in sorted(got.items()))


def phase_matrix(tmp, fof4k, fof2k):
    res = {}
    ref4 = os.path.join(tmp, "m4096_host.gz")
    with env(NIQKI_TPU_MATRIX="dense", **HOST_REF):
        res["host_4096_s"] = cli(["-M", fof4k, "-J", "0.05", "-S", str(S),
                                   "-O", ref4])
    want = gz_bytes(ref4)
    for sym, route in (("on", "matrix:selfjoin-sym"),
                       ("off", "matrix:selfjoin-full")):
        out = os.path.join(tmp, f"m4096_{sym}.gz")
        with env(NIQKI_TPU_MATRIX_SYM=sym), routes_taken() as got:
            res[f"sym_{sym}_4096_s"] = cli(["-M", fof4k, "-J", "0.05",
                                            "-S", str(S), "-O", out])
        require_routes("matrix", got, want=[route, "count:" + KERNEL],
                       forbid=HOST_OR_INTERPRET)
        check(gz_bytes(out) == want,
              f"matrix: G=4096 sym={sym} != dense host matrix")
    ref2 = os.path.join(tmp, "m2048_host.gz")
    with env(NIQKI_TPU_MATRIX="dense", **HOST_REF):
        res["host_2048_s"] = cli(["-M", fof2k, "-S", str(S), "-O", ref2])
    out = os.path.join(tmp, "m2048_dev.gz")
    with routes_taken() as got:
        res["dense_selfjoin_2048_s"] = cli(["-M", fof2k, "-S", str(S),
                                            "-O", out])
    require_routes("matrix", got, want=["matrix:selfjoin-full",
                                        "count:" + KERNEL],
                   forbid=HOST_OR_INTERPRET)
    check(gz_bytes(out) == gz_bytes(ref2),
          "matrix: G=2048 J=0 dense self-join != dense host matrix")
    say("matrix", ok=True, equal="bytes(host dense)", G4096_J=0.05,
        G2048_J=0, **{k: round(v, 2) for k, v in res.items()})


# ---------------------------------------------------------------------------
# --four: the mesh path

def phase_mesh(rng, tmp, devs):
    import numpy as np
    from niqki_tpu import SketchIndex, SketchParams, engine, native
    fof, qfof, fof4k, _ = make_hits_inputs(rng, tmp)
    res = {}
    out_dev = os.path.join(tmp, "hits_mesh.gz")
    out_ref = os.path.join(tmp, "hits_host.gz")
    with env(NIQKI_TPU_MESH="1x4"), routes_taken() as got:
        res["hits_mesh_s"] = cli(["-I", fof, "-Q", qfof, "-J", "0.05",
                                  "-S", str(S), "-O", out_dev])
    require_routes("mesh", got, want=["sketch:device", "count:" + KERNEL,
                                      "hits:sparse-mesh"],
                   forbid=HOST_OR_INTERPRET)
    with env(**HOST_REF):
        res["hits_host_s"] = cli(["-I", fof, "-Q", qfof, "-J", "0.05",
                                  "-S", str(S), "-O", out_ref])
    check(gz_bytes(out_dev) == gz_bytes(out_ref),
          "mesh: sharded hits != host routes")
    # ShardedIndex dense counts against the native host count
    with env(NIQKI_TPU_MESH="1x4"), routes_taken() as got:
        idx = SketchIndex(SketchParams(lF=S, min_fract=0.05))
        engine.insert_fof_whole(idx, fof)
        with open(qfof) as f:
            qpaths = [ln.strip() for ln in f if ln.strip()][:96]
        q = np.stack(idx.sketch_files(qpaths))
        t0 = time.perf_counter()
        c = idx.counts(q)
        res["sharded_counts_s"] = time.perf_counter() - t0
    require_routes("mesh", got, want=["count:mesh"], forbid=HOST_OR_INTERPRET)
    ref = native.count_eq(q, idx._stored(), idx.params.fingerprint_range)
    check((c == ref).all(), "mesh: ShardedIndex.counts != host count")
    del idx
    out_m = os.path.join(tmp, "m4096_mesh.gz")
    ref_m = os.path.join(tmp, "m4096_host.gz")
    with env(NIQKI_TPU_MESH="1x4"), routes_taken() as got:
        res["matrix_mesh_s"] = cli(["-M", fof4k, "-J", "0.05", "-S", str(S),
                                     "-O", out_m])
    require_routes("mesh", got, want=["matrix:selfjoin-mesh"],
                   forbid=HOST_OR_INTERPRET)
    with env(NIQKI_TPU_MATRIX="dense", **HOST_REF):
        res["matrix_host_s"] = cli(["-M", fof4k, "-J", "0.05", "-S", str(S),
                                     "-O", ref_m])
    check(gz_bytes(out_m) == gz_bytes(ref_m),
          "mesh: sharded self-join matrix != dense host matrix")
    mem = []
    for d in devs[:4]:
        st = d.memory_stats() or {}
        mem.append(f"{d.id}:{st.get('bytes_in_use', 0) / 2**30:.2f}/"
                   f"{st.get('peak_bytes_in_use', 0) / 2**30:.2f}GiB")
    say("mesh", ok=True, mesh="1x4", equal="bytes(host),counts(host)",
        memory_in_use_peak=",".join(mem),
        **{k: round(v, 2) for k, v in res.items()})


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh path on four GPUs")
    args = ap.parse_args(argv)
    phase = "device"
    try:
        import jax
        import numpy as np
        devs = phase_device(args.four)
        rng = np.random.default_rng(args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.four:
                phase = "mesh"
                phase_mesh(rng, tmp, devs)
            else:
                phase = "kernels"
                phase_kernels(rng)
                phase = "sketch"
                phase_sketch(rng, tmp)
                phase = "hits"
                fof, qfof, fof4k, fof2k = make_hits_inputs(rng, tmp)
                phase_hits(tmp, fof, qfof)
                phase = "matrix"
                phase_matrix(tmp, fof4k, fof2k)
        d = jax.devices()
    except SmokeFailure as e:
        print(f"[{phase}] FAIL {e}", flush=True)
        return 1
    except Exception as e:  # any crash is a failed phase, not a result
        import traceback
        traceback.print_exc()
        print(f"[{phase}] FAIL {type(e).__name__}: {e}", flush=True)
        return 1
    if REHEARSAL:
        print("rehearsal passed (no result line off the GPU)", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
