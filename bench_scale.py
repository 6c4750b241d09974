"""Scale benchmarks: the BASELINE.md north-star metrics on the GPU.

Measures, on one device:
  * sketch throughput (Mbp/s) for whole-genome batch ingest (ecoli set,
    looped), end to end from gzip bytes on disk;
  * query hit-counting throughput against a synthetic 100k-genome index
    (G x F fingerprints resident in device memory as bit-planes);
  * end-to-end query rate (sketch + count + threshold/sort) for genome-sized
    queries against that index.

Each metric prints one JSON line. The reference CPU anchors (BASELINE.md):
sketching ~25 Mbp/s/thread (~1.6 Gbp/s extrapolated to 64 cores), hits-query
dominated by re-sketching (~5.5 genomes/s/thread, ~350/s on 64 cores).

Usage: python bench_scale.py [--genomes 100000]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _synth_genomes_file(n: int, length: int) -> str:
    """A cached on-disk FASTA of n random genomes (one record each)."""
    import gzip
    cache = os.path.expanduser("~/.cache/niqki_tpu")
    os.makedirs(cache, exist_ok=True)
    # v2: the v1 generator drew int64 code points, so .tobytes() emitted 8
    # bytes per base (ACGT + 7 NULs) — every record was 8x longer than
    # intended and mostly non-ACGT garbage.
    path = os.path.join(cache, f"synth_{n}x{length}.v2.fa.gz")
    if os.path.exists(path):
        return path
    log(f"generating {path} ({n} x {length} bp)...")
    rng = np.random.default_rng(42)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    t0 = time.time()
    with gzip.open(path + ".tmp", "wb", compresslevel=1) as f:
        for i in range(n):
            seq = rng.choice(alphabet, length).tobytes()
            f.write(b">synth%d\n%s\n" % (i, seq))
    os.rename(path + ".tmp", path)
    log(f"generated in {time.time()-t0:.0f}s")
    return path


def _synth_clustered_file(n: int, length: int, clusters: int,
                          mut: float = 0.02, seed: int = 7) -> str:
    """A cached FASTA of `clusters` random ancestors, each expanded into
    n/clusters descendants by point mutations (niqki_tpu/synth.py).
    Queries drawn from this set return a whole cluster of real hits — the
    skewed workload that uniform-random genomes (near-zero counts) never
    stress."""
    import gzip
    from niqki_tpu import synth
    cache = os.path.expanduser("~/.cache/niqki_tpu")
    os.makedirs(cache, exist_ok=True)
    sfx = "" if seed == 7 else f".s{seed}"
    path = os.path.join(cache, f"synthc_{n}x{length}c{clusters}{sfx}.v2.fa.gz")
    if os.path.exists(path):
        return path
    log(f"generating {path} ({clusters} clusters x ~{n//clusters})...")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    with gzip.open(path + ".tmp", "wb", compresslevel=1) as f:
        for gid, (c, seq) in enumerate(synth.clustered_genomes(
                rng, n, length, clusters, mut)):
            f.write(b">c%d_%d\n%s\n" % (c, gid, seq.tobytes()))
    os.rename(path + ".tmp", path)
    log(f"generated in {time.time()-t0:.0f}s")
    return path


def _mutant_query_fof(q: int, div: float = 0.01, seed: int = 0) -> str:
    """A cached fof of q DISTINCT whole-genome query files: the 9 bundled
    E. coli genomes (~4.64 Mbp) each expanded into q/9 point-mutated
    variants (iid rate `div`), one gzip FASTA per file — the reference's
    own hits-query workload (re-sketch every query file) at Q >= 288 scale.
    Every file's content is unique, so the host page cache cannot fake the
    timing. Distinct `seed`s give disjoint sets, so repeated timed passes
    stay honest."""
    import gzip
    cache = os.path.expanduser("~/.cache/niqki_tpu")
    d = os.path.join(cache, f"ecoli_mut{q}.v1" if seed == 0
                     else f"ecoli_mut{q}.s{seed}.v1")
    fof = os.path.join(d, "fof.txt")
    if os.path.exists(fof):
        return fof
    from niqki_tpu.io.fasta import read_records
    seqs = []
    for i in range(1, 10):
        for _, s in read_records(
                f"/root/reference/resources/ecoli0{i}p.fa.gz", 31):
            seqs.append(np.frombuffer(s, np.uint8).copy())
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    os.makedirs(d, exist_ok=True)
    log(f"generating {q} mutant query genomes in {d}...")
    t0 = time.time()

    def gen(i: int) -> str:
        rng = np.random.default_rng(100_000 * seed + 1000 + i)
        base = seqs[i % len(seqs)]
        m = rng.random(len(base)) < div
        seq = np.where(m, rng.choice(alphabet, len(base)), base)
        path = os.path.join(d, f"mut{i:04d}.fa.gz")
        with gzip.open(path + ".tmp", "wb", compresslevel=1) as f:
            f.write(b">mut%d\n" % i)
            f.write(seq.tobytes())
            f.write(b"\n")
        os.rename(path + ".tmp", path)
        return path

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        paths = list(ex.map(gen, range(q)))
    with open(fof + ".tmp", "w") as f:
        f.write("\n".join(paths) + "\n")
    os.rename(fof + ".tmp", fof)
    log(f"generated in {time.time()-t0:.0f}s")
    return fof


def bench_real_query(idx, tag: str, queries: int = 288):
    """THE north-star metric: e2e whole-genome query
    rate against a 100k-genome index through the PRODUCTION path
    (engine.query_fof_whole -> pipelined sketch_files + pretty_hits_batch
    sparse top-k), at Q >= 288 real files so fixed overheads amortize.
    Reports the component split (sketch-only, count-only) alongside —
    the e2e wall should approach max(sketch, count), not their sum."""
    from niqki_tpu import engine
    from niqki_tpu.io.writers import GzTextWriter
    p = idx.params
    # Give every mutant query a REAL hit: the 9 ancestor E. coli genomes
    # join the synthetic index, so hit extraction + pretty formatting are
    # on the timed path (an all-synthetic index returns zero hits and
    # exercises them trivially).
    for i, path in enumerate(f"/root/reference/resources/ecoli0{j}p.fa.gz"
                             for j in range(1, 10)):
        idx.insert_sketch(idx.sketch_file(path), f"ecoli0{i+1}p")
    fof = _mutant_query_fof(queries)
    with open(fof) as f:
        paths = [ln.strip() for ln in f if ln.strip()]

    # warm the top-k compile with synthetic sketches (fresh wire bytes)
    rng = np.random.default_rng(9)
    warm_q = rng.integers(0, p.fingerprint_range,
                          (queries, p.F)).astype(np.int32)
    idx.pretty_hits_batch(warm_q, [f"w{i}" for i in range(queries)])

    # component: sketch-only
    t0 = time.time()
    sks = idx.sketch_files(paths)
    sketch_dt = time.time() - t0

    # component: count-only through the sparse path, on XOR-perturbed
    # sketches (fresh bytes, not the ones the e2e pass below times)
    qpert = np.stack(sks).astype(np.int32) ^ 1
    qpert = np.where((qpert < 0) | (qpert >= p.fingerprint_range), -3, qpert)
    t0 = time.time()
    buf = idx.pretty_hits_batch(qpert, [f"p{i}" for i in range(len(qpert))])
    count_dt = time.time() - t0
    assert buf is not None

    # e2e: best-of-2 over DISTINCT mutant sets. Neither rep reuses the
    # component pass's seed-0 set: its files are page-cache warm after the
    # sketch-only measurement, which would shave the cold-read share off
    # the e2e wall.
    import gzip
    walls, nhits = [], 0
    for rep_seed in (1, 2):
        rep_fof = _mutant_query_fof(queries, seed=rep_seed)
        out_path = os.path.join(tempfile.gettempdir(), "realq.gz")
        t0 = time.time()
        with GzTextWriter(out_path) as out:
            engine.query_fof_whole(idx, rep_fof, out)
        walls.append(time.time() - t0)
        with gzip.open(out_path, "rb") as f:
            body = f.read()
            nhits = body.count(b":")
            nrows = body.count(b"\n")
        os.unlink(out_path)
        assert nrows == queries, (nrows, queries)
    dt = min(walls)
    print(json.dumps({"metric": f"e2e_real_query_per_s_{tag}",
                      "value": round(queries / dt, 1), "unit": "queries/s",
                      "queries": queries, "wall_s": round(dt, 2),
                      "walls_s": [round(w, 2) for w in walls],
                      "sketch_only_s": round(sketch_dt, 2),
                      "count_only_s": round(count_dt, 2),
                      "sketch_only_qps": round(queries / sketch_dt, 1),
                      "count_only_qps": round(queries / count_dt, 1),
                      "vs_baseline_64core": round(queries / dt / 350.0, 2),
                      "hits_total": nhits}))


def bench_sketch_kernel(paths, p):
    """The DEVICE sketch kernel rate with RESIDENT packed input — no wire,
    no host decode. Fresh bytes per rep via a device-side xor of the
    packed words; timing covers the production batched kernel (int16 wire
    out) plus the host materialization of the (B, F) tables. Reference
    anchor: 25 Mbp/s/thread (src/niqki_index.cpp:335-358, BASELINE.md)."""
    import jax
    import jax.numpy as jnp
    from niqki_tpu import native
    from niqki_tpu.ops import sketch as sk
    recs = []
    for path in paths:
        for _, w, n, e in native.read_packed_records(path, p.K):
            recs.append((w, n, e))
    P = max(sk.padded_size(n) for _, n, _ in recs)
    Pw = P // 16
    B = len(recs)
    w = np.zeros((B, Pw), np.uint32)
    nk = np.zeros((B,), np.int32)
    ex = np.full((B, 8), sk.EXC_PAD, np.int32)
    for row, (words, n, exc) in enumerate(recs):
        w[row, :len(words)] = words
        nk[row] = n - p.K
        # exceptions dropped: the xor perturbation rewrites bases anyway,
        # and an empty exception list keeps the compiled shape fixed
    wd = jax.block_until_ready(jnp.asarray(w))
    nkd, exd = jnp.asarray(nk), jnp.asarray(ex)
    base = sk._sketch_packed_batch_impl

    def run(wr):
        out = base(wr, nkd, exd, lF=p.lF, K=p.K, W=p.W, H=p.H,
                   mask_M=p.mask_M, max_rem=p.maximal_remainder,
                   to_i16=True)
        return np.asarray(out)

    perturb = jax.jit(lambda a, r: a ^ r)
    run(wd)  # warm compile
    total_bp = int(nk.sum())
    best = float("inf")
    for r in range(4):
        wr = jax.block_until_ready(perturb(wd, jnp.uint32(r + 1)))
        t0 = time.time()
        run(wr)
        best = min(best, time.time() - t0)
    mbps = total_bp / best / 1e6
    print(json.dumps({"metric": "sketch_kernel_mbps",
                      "value": round(mbps, 1), "unit": "Mbp/s",
                      "batch_records": B, "batch_mbp": round(total_bp / 1e6, 1),
                      "vs_baseline_1thread": round(mbps / 25.0, 1)}))


def bench_ingest_e2e(n: int, length: int, s15: bool = False):
    """A REAL n-genome ingest through the
    production pipeline (gzip -> native parse/pack -> device sketch ->
    densify -> index), then sharded dump + reload, then real genome queries
    against the built index — no jax.random sketches anywhere.

    s15=True runs the reference's GOLDEN configuration (S=15, F=32768): the
    100k-genome matrix is 13 GB of host int32, the checkpoint 13 GB on
    disk, and the device planes 5.3 GB — the sizes every headline claim
    must survive."""
    from niqki_tpu import SketchIndex, SketchParams
    path = _synth_genomes_file(n, length)
    if s15:
        p = SketchParams(min_fract=0.05)      # defaults: F=32768
        tag = f"G{n}_s15"
    else:
        p = SketchParams(lF=12, min_fract=0.05)  # F=4096: 100k rows=1.6 GB
        tag = f"G{n}"
    idx = SketchIndex(p)
    # small warm-up file for compile (separate shapes stay warm in cache)
    idx_w = SketchIndex(p)
    idx_w.insert_file_lines(_synth_genomes_file(64, length))
    t0 = time.time()
    idx.insert_file_lines(path)
    dt = time.time() - t0
    gps = idx.G / dt
    print(json.dumps({"metric": f"ingest_genomes_per_s_{tag}",
                      "value": round(gps, 1), "unit": "genomes/s",
                      "mbp_per_s": round(idx.G * length / dt / 1e6, 1),
                      "wall_s": round(dt, 1)}))
    assert idx.G == n, (idx.G, n)

    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ckpt")
        t0 = time.time()
        idx.save_sharded(ck, num_shards=8, compress=False)
        save_s = time.time() - t0
        t0 = time.time()
        idx2 = SketchIndex.load_sharded(ck)
        load_s = time.time() - t0
        assert idx2.G == n
        print(json.dumps({"metric": f"sharded_ckpt_roundtrip_s_{tag}",
                          "value": round(save_s + load_s, 2), "unit": "s",
                          "save_s": round(save_s, 2),
                          "load_s": round(load_s, 2)}))
        if s15:
            # v3 (planes=True) save: the plane pack now runs per shard on
            # the save pool, overlapped with the O_DIRECT writes
            t0 = time.time()
            idx.save_sharded(os.path.join(td, "ckpt3"), num_shards=8,
                             compress=False, planes=True)
            print(json.dumps({"metric": f"ckpt_save_planes_s_{tag}",
                              "value": round(time.time() - t0, 2),
                              "unit": "s"}))

    # real whole-genome queries against the really-built index, through
    # the PRODUCTION path at Q=288 (engine.query_fof_whole: pipelined
    # sketch_files + pretty_hits_batch sparse top-k)
    bench_real_query(idx, tag)


def bench_matrix(n: int, length: int, s15: bool = False, seed: int = 7):
    """An all-vs-all matrix at G >= 10k through the
    production path (engine.query_matrix -> device self-join: zero query
    h2d, uint16 wrap + top-k compaction on device, native row formatting).
    The legacy path would d2h a dense (batch, G) int32 block per batch;
    this one ships only top-k survivors.

    Workload: clustered genomes (128 clusters of ~80 relatives at ~1.5%
    divergence) at lF=12 — F=4096 keeps the sketch DENSE for 10 kb genomes
    (a 10 kb genome has ~10k k-mers; at S=15's F=32768 most slots stay
    empty and densification makes even unrelated pairs score ~0.38, a
    degenerate regime the reference's own docs reserve for >=Mbp genomes;
    S=15 matrix parity is pinned at golden scale in
    tests/test_matrix_selfjoin.py)."""
    from niqki_tpu import SketchIndex, SketchParams, engine
    from niqki_tpu.io.writers import GzTextWriter
    path = _synth_clustered_file(n, length, clusters=128, seed=seed)
    if s15:
        # The golden S=15 (F=32768) config needs ~100 kb+ records for
        # dense sketches (~3 k-mers/slot); run it on the long-genome
        # clustered set rather than the 10 kb one (see the lF=12 note
        # above — 10 kb at F=32768 is the degenerate mostly-empty regime).
        p = SketchParams(min_fract=0.05)       # min_score=1638 of F=32768
        tag = f"G{n}_s15"
    else:
        p = SketchParams(lF=12, min_fract=0.05)  # min_score=204 of F=4096
        tag = f"G{n}"
    idx = SketchIndex(p)
    t0 = time.time()
    idx.insert_file_lines(path)
    ingest_s = time.time() - t0
    assert idx.G == n

    # Split the one-time index-residency cost (host rows -> device
    # bit-planes, ~2 B/slot h2d) out of the sweep wall, and warm the
    # self-join compile on XOR-PERTURBED planes: same shapes (compile
    # cache hit for the timed sweep) but different bytes.
    import jax
    import jax.numpy as jnp
    from niqki_tpu.ops import bcount
    t0 = time.time()
    idx._device_planes = bcount.build_index_planes(
        idx._stored(), p.W, sanitized=True)
    planes_s = time.time() - t0
    xp = idx._device_planes
    Gp = xp.shape[1]
    B = min(bcount.MATRIX_BLOCK, Gp)
    cap = min(Gp, int(os.environ.get("NIQKI_TPU_MATRIX_CAP", "1024")))
    xpw = jnp.concatenate([xp[:p.W] ^ np.uint32(1), xp[p.W:]], 0)
    # the same count implementation and sweep choice as
    # engine._query_matrix_selfjoin, so the warmup compiles the jit
    # signature the timed sweep uses
    impl = bcount.count_impl()
    sym_env = os.environ.get("NIQKI_TPU_MATRIX_SYM", "auto")
    if p.min_score > 0 and sym_env in ("on", "auto"):
        # warm the symmetric sweep's WIDEST window shape (the dominant
        # compile; narrower quantized widths compile during the sweep and
        # amortize over reruns via the persistent compile cache)
        QB = max(1, int(os.environ.get("NIQKI_TPU_MATRIX_QB", "8")))
        N = -(-Gp // B)
        Gtot = (N + QB - 1) * B
        xpe = bcount.extend_planes(xpw, Gtot - Gp)
        jax.block_until_ready(bcount._self_join_window_topk(
            xpe, 0, p.min_score, B=B, w=min(N, -(-N // QB) * QB), cap=cap,
            impl=impl))
        del xpe
    else:
        jax.block_until_ready(bcount._self_join_topk(
            xpw, 0, p.min_score, B=B, cap=cap, impl=impl))
    del xpw

    out_path = os.path.join(tempfile.gettempdir(), f"matrix_{tag}.gz")
    t0 = time.time()
    with GzTextWriter(out_path) as out:
        engine.query_matrix(idx, out)
    dt = time.time() - t0
    sz = os.path.getsize(out_path)
    os.unlink(out_path)
    print(json.dumps({"metric": f"matrix_rows_per_s_{tag}",
                      "value": round(n / dt, 1), "unit": "rows/s",
                      "wall_s": round(dt, 1),
                      "ingest_s": round(ingest_s, 1),
                      "plane_build_s": round(planes_s, 1),
                      "gz_bytes": sz,
                      "cells_per_s": round(n * n / dt / 1e6, 1)}))


def bench_skewed_query(n: int, length: int, queries: int = 288):
    """E2e query rate when every query returns a whole
    CLUSTER of real hits (~n/100 genomes), so the hit-extraction argsort
    and the native pretty formatter are on the hot path — uniform-random
    workloads return near-zero hits and never stress them."""
    from niqki_tpu import SketchIndex, SketchParams, native
    path = _synth_clustered_file(n, length, clusters=100)
    p = SketchParams(lF=12, min_fract=0.05)
    idx = SketchIndex(p)
    idx.insert_file_lines(path)
    assert idx.G == n
    mat = idx.matrix()
    step = max(1, n // queries)
    qsel = np.ascontiguousarray(mat[::step][:queries])
    headers = [f"q{i}" for i in range(queries)]

    def run(q):
        # the production pretty path (engine.query_fof_whole): sparse
        # device top-k, only survivors cross d2h
        t0 = time.time()
        buf = idx.pretty_hits_batch(q, headers)
        assert buf is not None
        return time.time() - t0, buf

    # warm with different genomes; the timed rep uses the real query
    # sketches
    run(np.ascontiguousarray(mat[1::step][:queries]))
    dt, buf = run(qsel)
    nhits = buf.count(b":")
    # dense-path comparison (the pre-sparse production path)
    fmt = native.HitsFormatter(idx.names, p.F, p.min_score)
    t0 = time.time()
    counts = idx.counts(np.ascontiguousarray(mat[2::step][:queries]))
    fmt.format(counts, headers)
    dense_dt = time.time() - t0
    print(json.dumps({"metric": f"e2e_query_per_s_G{n}_skewed",
                      "value": round(len(qsel) / dt, 1),
                      "unit": "queries/s",
                      "hits_total": nhits,
                      "hits_per_query": round(nhits / len(qsel), 1),
                      "dense_path_qps": round(len(qsel) / dense_dt, 1),
                      "formatted_mb": round(len(buf) / 1e6, 1)}))


def bench_restart(n: int, length: int, s15: bool = False):
    """Serving restart-to-first-query at G=100k.
    Compares the mesh-direct v3 path (ShardedIndex.from_checkpoint:
    persisted planes device_put straight to their 'tp' owner, no host
    matrix) against the legacy restart (load_sharded -> counts() builds
    planes from rows). Checkpoints are built once and cached."""
    from niqki_tpu import SketchIndex, SketchParams
    from niqki_tpu.parallel.serving import ShardedIndex
    p = SketchParams(min_fract=0.05) if s15 else \
        SketchParams(lF=12, min_fract=0.05)
    tag = f"G{n}_s15" if s15 else f"G{n}"
    cache = os.path.expanduser("~/.cache/niqki_tpu")
    ck = os.path.join(cache, f"ckpt_{n}_{'s15' if s15 else 'lf12'}.v1")
    if not os.path.exists(os.path.join(ck, "manifest.json")):
        log(f"building cached checkpoint {ck}...")
        idx = SketchIndex(p)
        idx.insert_file_lines(_synth_genomes_file(n, length))
        idx.save_sharded(ck, num_shards=8, compress=False, planes=True)

    rng = np.random.default_rng(4)
    q = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)

    t0 = time.time()
    srv = ShardedIndex.from_checkpoint(ck)
    h1 = srv.hits(q)
    v3_s = time.time() - t0
    del srv   # free the serving planes before the legacy path builds its
              # own (at S=15 two copies plus the chunked-pack transient)

    t0 = time.time()
    idx2 = SketchIndex.load_sharded(ck)
    h2 = idx2.hits(q)
    legacy_s = time.time() - t0
    assert h1 == h2
    print(json.dumps({"metric": f"restart_to_first_query_s_{tag}",
                      "value": round(v3_s, 2), "unit": "s",
                      "legacy_restart_s": round(legacy_s, 2)}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=288)
    ap.add_argument("--ingest-genomes", type=int, default=100_000,
                    help="real e2e ingest size (0 skips the e2e section)")
    ap.add_argument("--ingest-len", type=int, default=10_000)
    ap.add_argument("--matrix-genomes", type=int, default=10_240,
                    help="all-vs-all matrix size (0 skips the section)")
    ap.add_argument("--matrix-s15-genomes", type=int, default=0,
                    help="all-vs-all matrix at the golden S=15 config on "
                         "long clustered genomes (0 skips)")
    ap.add_argument("--matrix-s15-len", type=int, default=100_000)
    ap.add_argument("--matrix-seed", type=int, default=7,
                    help="clustered-input RNG seed: a fresh seed gives a "
                         "never-before-seen input set")
    ap.add_argument("--s15", action="store_true", default=True,
                    help="also run the ingest/ckpt/query section at the "
                         "reference's golden S=15 (F=32768) sizes")
    ap.add_argument("--no-s15", dest="s15", action="store_false")
    ap.add_argument("--skip-base", action="store_true",
                    help="skip the sketch-throughput / synthetic-count / "
                         "synthetic-e2e sections (targeted matrix or "
                         "ingest runs)")
    ap.add_argument("--north-star", action="store_true",
                    help="ONLY build the S=15 G=--ingest-genomes index and "
                         "run the e2e real-file query metric (no ckpt/"
                         "matrix/base sections — fast iteration on the "
                         "query path)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from niqki_tpu import SketchIndex, SketchParams
    log(f"devices: {jax.devices()}")
    p = SketchParams()  # defaults K=31 S=15 W=12 H=4
    paths = [f"/root/reference/resources/ecoli0{i}p.fa.gz"
             for i in range(1, 10)]

    if args.north_star:
        from niqki_tpu import SketchIndex as SI
        idxn = SI(SketchParams(min_fract=0.05))
        idxn.insert_file_lines(
            _synth_genomes_file(args.ingest_genomes, args.ingest_len))
        bench_real_query(idxn, f"G{args.ingest_genomes}_s15",
                         queries=args.queries)
        return 0

    if args.skip_base:
        if args.matrix_genomes:
            bench_matrix(args.matrix_genomes, args.ingest_len,
                         seed=args.matrix_seed)
        if args.matrix_s15_genomes:
            bench_matrix(args.matrix_s15_genomes, args.matrix_s15_len,
                         s15=True, seed=args.matrix_seed)
        if args.ingest_genomes:
            bench_ingest_e2e(args.ingest_genomes, args.ingest_len)
            bench_skewed_query(args.ingest_genomes, args.ingest_len)
            bench_restart(args.ingest_genomes, args.ingest_len)
            if args.s15:
                bench_ingest_e2e(args.ingest_genomes, args.ingest_len,
                                 s15=True)
                bench_restart(args.ingest_genomes, args.ingest_len,
                              s15=True)
        return 0

    # --- sketch throughput -------------------------------------------------
    # Rotate the file order per rep (different batch stacking => different
    # buffers).
    idx = SketchIndex(p)
    idx.sketch_files(paths)  # warm compile + page cache
    best = float("inf")
    for r in range(1, 5):  # best-of-4
        order = paths[r % 9:] + paths[:r % 9]
        t0 = time.time()
        sks = idx.sketch_files(order)
        best = min(best, time.time() - t0)
    total_bp = 9 * 4_639_675
    mbps = total_bp / best / 1e6
    print(json.dumps({"metric": "sketch_throughput", "value": round(mbps, 1),
                      "unit": "Mbp/s",
                      "vs_baseline_1thread": round(mbps / 25.0, 1),
                      "vs_baseline_64core": round(mbps / 1600.0, 2)}))

    # --- device sketch KERNEL rate (resident input, no wire) --------------
    bench_sketch_kernel(paths, p)

    # --- synthetic 100k-genome index (bit-plane kernel, the auto route) ---
    from niqki_tpu.ops import bcount
    G, F, W = args.genomes, p.F, p.W
    Gp = -(-G // bcount.TILE_G) * bcount.TILE_G
    L = F // 32
    log(f"building synthetic index G={G} F={F} ({(W+1)} bit-planes, "
        f"{(W+1)*Gp*L*4/1e9:.1f} GB of device memory)...")

    @jax.jit
    def synth(key):
        # Directly in the count kernel's wire format: W random value planes
        # plus an all-valid sentinel plane.
        bits = jax.random.bits(key, (W, Gp, L), dtype=jnp.uint32)
        return jnp.concatenate([bits, jnp.zeros((1, Gp, L), jnp.uint32)], 0)

    xp = synth(jax.random.PRNGKey(0))
    xp.block_until_ready()

    qs = np.stack(sks)  # 9 real sketches
    reps_q = max(1, args.queries // len(qs))
    qnp = np.tile(qs, (reps_q, 1)).astype(np.int32)
    Q = qnp.shape[0]
    Qp = -(-Q // bcount.BLOCK_Q) * bcount.BLOCK_Q

    # The e2e count rate measures the PRODUCTION pipelined wire
    # (ops/bcount.match_counts_planes): query blocks shipped one BLOCK_Q at
    # a time with the next block's h2d overlapping the current block's
    # fused pack+count dispatch. The hit-count reduce stays on device; only
    # (Q,) totals cross back.
    thresh = 1638  # J=0.05 at F=32768

    @jax.jit
    def hits_reduce(c):
        return (c >= thresh).sum(axis=1, dtype=jnp.int32)

    impl = bcount.count_impl()

    def count_hits_e2e(q_np):
        t0 = time.time()
        c = bcount.match_counts_planes(q_np, xp, Gp, W, impl, sanitized=True)
        nh = np.asarray(hits_reduce(c))
        return time.time() - t0, nh

    # warm with a DIFFERENT batch; best-of-3 with fresh bytes each rep.
    def fresh(r):
        # XOR makes fresh wire bytes; sanitize OUTSIDE the timer so the
        # timed path can use the sanitized=True contract like index.counts
        # does after _query_side.
        q = qnp ^ (r + 1)
        return np.where((q < 0) | (q >= (1 << W)), -3, q)

    count_hits_e2e(fresh(0))
    wall = min(count_hits_e2e(fresh(r + 1))[0] for r in range(3))
    qps = Q / wall

    # Kernel-only rate: query planes resident on device, fresh bytes per
    # rep via a cheap device-side xor.
    qp0 = bcount.pack_bitplanes(
        jnp.asarray(np.where(qnp < 0, np.int32(-3), qnp)), W=W, query=True)
    qp0.block_until_ready()

    qp0 = jnp.pad(qp0, ((0, 0), (0, Qp - Q), (0, 0)))

    @jax.jit
    def kernel_sweep(qp, planes):
        return (bcount._count(qp, planes, impl) >= thresh).sum(
            1, dtype=jnp.int32)

    np.asarray(kernel_sweep(qp0, xp))  # warm
    kern = float("inf")
    for r in range(3):
        qpr = (qp0 ^ np.uint32(r + 1)).block_until_ready()
        t0 = time.time()
        np.asarray(kernel_sweep(qpr, xp))
        kern = min(kern, time.time() - t0)

    # Work accounting: per query-word the count does 2 ops per plane (the
    # XNOR chain over W+1 planes), a popcount, and an accumulate.
    sweeps = Qp / bcount.BLOCK_Q
    plane_bytes = (W + 1) * Gp * L * 4
    iops = Qp * Gp * L * (2 * (W + 1) + 2)  # padded lanes execute too
    print(json.dumps({"metric": f"count_queries_per_s_G{G}",
                      "value": round(qps, 1), "unit": "queries/s",
                      "kernel_only_qps": round(Q / kern, 1),
                      "pipelined_wall_s": round(wall, 3),
                      "vs_baseline_64core": round(qps / 350.0, 1),
                      "kernel_int_ops_per_s": round(iops / kern / 1e12, 2),
                      "kernel_plane_bytes_per_s": round(
                          sweeps * plane_bytes / kern / 1e9, 1)}))

    # --- end-to-end query rate (sketch + count + hits) --------------------
    # J=0.05 reporting threshold: at J=0 every query returns all G genomes
    # and host-side hit formatting dominates (degenerate workload).
    idx2 = SketchIndex(SketchParams(min_fract=0.05))
    idx2.names = [f"g{i}" for i in range(G)]

    @jax.jit
    def nine_counts(q, planes):
        qp = bcount.pack_bitplanes(q, W=W, query=True)
        return bcount._count(qp, planes, impl)[:9, :G]  # slice pre-d2h

    def q_block(sketches):
        q = np.full((bcount.BLOCK_Q, F), -3, np.int16)
        q[:9] = np.stack(sketches)
        return jnp.asarray(q)

    # warm the compile with a different file order (fresh device bytes)
    np.asarray(nine_counts(q_block(
        idx2.sketch_files(list(reversed(paths)))), xp))
    timed_order = paths[5:] + paths[:5]
    t0 = time.time()
    counts = np.asarray(nine_counts(q_block(
        idx2.sketch_files(timed_order)), xp))
    hits = [idx2.hits_from_counts(c) for c in counts]
    dt = time.time() - t0
    print(json.dumps({"metric": f"e2e_query_per_s_G{G}",
                      "value": round(9 / dt, 2), "unit": "queries/s",
                      "vs_baseline_64core": round(9 / dt / 350.0, 2),
                      "hits_total": int(sum(len(h) for h in hits))}))

    # Free the synthetic device index before the real-ingest sections: the
    # S=15 sections build their own 5.3 GB planes with a ~2x transient
    # during the chunked pack.
    del xp, qp0

    # --- all-vs-all matrix at scale (device self-join path) ---------------
    if args.matrix_genomes:
        bench_matrix(args.matrix_genomes, args.ingest_len,
                     seed=args.matrix_seed)
    if args.matrix_s15_genomes:
        bench_matrix(args.matrix_s15_genomes, args.matrix_s15_len, s15=True,
                     seed=args.matrix_seed)

    # --- real 100k-genome end-to-end (build-side scale) -------------------
    if args.ingest_genomes:
        bench_ingest_e2e(args.ingest_genomes, args.ingest_len)
        bench_skewed_query(args.ingest_genomes, args.ingest_len)
        bench_restart(args.ingest_genomes, args.ingest_len)
        if args.s15:
            bench_ingest_e2e(args.ingest_genomes, args.ingest_len, s15=True)
            bench_restart(args.ingest_genomes, args.ingest_len, s15=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
