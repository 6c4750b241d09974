"""SketchIndex: the dense device-resident genome sketch index.

Replaces the reference's 2^(S+W) pointer-chased posting lists
(/root/reference/src/niqki_index.cpp:27, 362-370) with one dense (G, F) int32
fingerprint matrix: every fully-densified sketch has exactly one fingerprint
per slot, so the "inverted index" is just the stacked sketches — 2-4 bytes per
slot instead of a 24-byte vector header per bucket, resident in device
memory, and queries become blocked equality-count reductions (ops/bcount.py,
ops/count.py).

Counts produced are identical to the reference's posting-list scans by
construction: genome g is in bucket (slot i, fp v) iff sketches[g, i] == v.
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from . import hostmem, native, oracle
from .debug import dbg, note
from .dumpfmt import load_dump, save_dump
from .io.fasta import read_records
from .params import SketchParams


def _densify(sketch: np.ndarray, p: SketchParams) -> None:
    """In-place densification: native C++ when built, oracle otherwise."""
    if native.available():
        native.densify(sketch)
    else:
        oracle.densify(sketch, p)


def hits_from_counts(counts: np.ndarray, min_score: int
                     ) -> list[tuple[int, int]]:
    """Thresholded (count, gid) list sorted count desc then gid desc,
    exactly like the reference's query_sketch ordering (the single source of
    the hit-ranking rule — the sharded serving path uses it too)."""
    c = np.asarray(counts)
    sel = np.nonzero(c >= min_score)[0]
    order = np.lexsort((-sel, -c[sel].astype(np.int64)))
    return [(int(c[g]), int(g)) for g in sel[order]]


def maybe_active_mesh():
    """The production-mesh gate shared by counts / pretty_hits_batch / the
    engine's matrix route: a jax-free env pre-check first (importing
    .parallel pulls jax in at module scope, which a host-routed job must
    not do), then parallel.auto.active_mesh(). Returns the active Mesh or
    None."""
    spec = os.environ.get("NIQKI_TPU_MESH", "auto").strip().lower()
    if spec in ("off", "none", "0", "1", "1x1"):
        return None
    from .parallel.auto import active_mesh
    return active_mesh()


def hits_from_counts_batch(counts: np.ndarray, min_score: int
                           ) -> list[list[tuple[int, int]]]:
    """hits_from_counts over a whole (B, G) block with ONE argsort: the
    per-row numpy-call overhead dominates read-scale query formatting.
    Composite key = -(count * G + gid), so ASCENDING key order is exactly
    count desc then gid desc; sub-threshold entries key to +1 (after every
    survivor). The key buffer is hugepage-backed and computed in place: at
    the dense fallback's G=100k/B=2048 the np.where + negation temps were
    ~3.2 GB of exactly the first-touch allocation pattern hostmem.py
    documents as pathological; the sorted-column gids ARE the gids, so no
    take_along_axis pass is needed either."""
    c = np.asarray(counts)
    B, G = c.shape
    if G == 0:
        return [[] for _ in range(B)]
    from . import hostmem
    keys = hostmem.big_empty((B, G), np.int64)
    keys[:] = c            # widen to int64 first: count*G overflows int32
    keys *= -G
    keys -= np.arange(G, dtype=np.int64)[None, :]
    keys[c < min_score] = 1
    order = np.argsort(keys, axis=1, kind="stable")
    nhits = (c >= min_score).sum(axis=1)
    return [[(int(c[b, g]), int(g)) for g in order[b, :nhits[b]]]
            for b in range(B)]


class SketchIndex:
    def __init__(self, params: SketchParams, backend: str = "jax"):
        self.params = params
        self.backend = backend
        self.names: list[str] = []
        self._rows: list[np.ndarray] = []
        self._mat: np.ndarray | None = None  # consolidated (G, F)
        self._mat_loader = None              # lazy loader (mesh-direct load)
        self._device_mat = None              # cached device copy
        self._device_planes = None           # cached bit-plane device copy
        self._sharded = None                 # cached multi-chip ShardedIndex
        self._hits_fmt = None                # cached native HitsFormatter
        self._stored_host = None             # cached host count-side matrix

    # ------------------------------------------------------------------
    # sketching
    def sketch_records(self, seqs) -> np.ndarray:
        """Whole-file semantics: all records accumulate into one sketch
        (per-record min-merge + densify). Returns (F,) int32 with -1 empty."""
        p = self.params
        if self.backend == "numpy":
            return oracle.sketch_records(seqs, p)
        from .ops.sketch import sketch_codes, INT32_MAX
        sketch = np.full(p.F, -1, dtype=np.int32)
        for seq in seqs:
            eff_fwd, eff_rc = oracle.encode_record(seq, p.K)
            table = sketch_codes(eff_fwd, eff_rc, p)
            cur = np.where(sketch == -1, INT32_MAX, sketch)
            merged = np.minimum(cur, table)
            sketch = np.where(merged == INT32_MAX, -1, merged).astype(np.int32)
            _densify(sketch, p)
        return sketch

    def _host_sketch_route(self) -> bool:
        """Whole-file sketching on the host (staged AVX-512 rolling
        sketcher, native lib) instead of the device kernel.
        NIQKI_TPU_SKETCH=host|device|auto; auto (the default) sketches on
        the device."""
        mode = os.environ.get("NIQKI_TPU_SKETCH", "auto")
        return (mode == "host" and self.backend != "numpy"
                and native.available())

    def _host_sketch_whole(self, recs, threads: int = 1) -> np.ndarray:
        p = self.params
        return native.sketch_packed_whole(
            recs, p.lF, p.K, p.W, p.H, p.mask_M, p.maximal_remainder,
            threads=threads)

    def sketch_file(self, path: str) -> np.ndarray:
        if self._host_sketch_route():
            # A single-file call owns the whole host: split the record's
            # window range across all cores (bit-identical chunked roll).
            note("sketch:host")
            return self._host_sketch_whole(
                [(w, n, e) for _, w, n, e
                 in native.read_packed_records_chunked(path, self.params.K)],
                threads=os.cpu_count() or 1)
        return self.sketch_records(s for _, s in read_records(path, self.params.K))

    # ------------------------------------------------------------------
    # pipelined many-file sketching
    def _load_packed(self, path: str):
        """Host phase: parse + pack every record of one file into the 2-bit
        wire format (words, n_bases, exc_idx).

        Uses the native C++ reader (gzip + parse + pack, GIL released, so the
        thread pool gets real parallelism) when built; pure Python io.fasta +
        oracle + pack_codes otherwise.
        """
        p = self.params
        try:
            if native.available():
                return [(w, n, e) for _, w, n, e
                        in native.read_packed_records(path, p.K)]
            from .ops.sketch import pack_codes
            return [pack_codes(*oracle.encode_record(s, p.K), p.K)
                    for _, s in read_records(path, p.K)]
        except (OSError, EOFError, zlib.error) as e:
            # Unreadable / truncated / corrupt files (including broken
            # deflate streams) are skipped like the reference skips missing
            # fof entries — ingest keeps going, but loudly: a silently
            # empty sketch would make the genome match nothing (the
            # reference aborts on broken deflate streams).
            import sys
            print(f"Warning: skipping unreadable file '{path}': {e}",
                  file=sys.stderr)
            return []

    def _finalize_tables(self, tables) -> np.ndarray:
        """Sequential per-record min-merge + densify (reference semantics:
        densified fillers from earlier records participate in later mins)."""
        p = self.params
        from .ops.sketch import INT32_MAX
        sketch = np.full(p.F, -1, dtype=np.int32)
        for t in tables:
            if t is None:
                continue
            table = np.asarray(t)
            if table.dtype == np.int16:  # narrow device wire, -1 sentinel
                table = np.where(table == -1, INT32_MAX,
                                 table.astype(np.int32))
            cur = np.where(sketch == -1, INT32_MAX, sketch)
            merged = np.minimum(cur, table)
            sketch = np.where(merged == INT32_MAX, -1, merged).astype(np.int32)
            _densify(sketch, p)
        return sketch

    def sketch_files(self, paths, window: int = 32,
                     io_threads: int | None = None) -> list[np.ndarray]:
        """Whole-file sketches for many files, fully pipelined and batched.

        Per window of files: host read+encode on a thread pool (the native
        reader releases the GIL), then ALL the window's records are stacked
        and shipped in one transfer and sketched by one vmapped kernel call,
        while the next window loads and the previous window's tables are
        collected and densified. Memory stays bounded by two windows in
        flight, so this
        scales to very large fofs.
        """
        paths = list(paths)
        if self.backend == "numpy":
            return [self.sketch_file(p) for p in paths]
        if self._host_sketch_route():
            note("sketch:host", len(paths))
            # 2x CPU oversubscription: each task chains cold file IO with
            # CPU-bound decode+sketch, so extra workers hide the IO stalls
            # under compute (measured on the Q=288 north-star set, page
            # cache dropped: 4 workers 366 Mbp/s, 8 workers 568 Mbp/s on
            # 4 cores; 12 workers regresses).
            io_threads = io_threads or min(8, 2 * (os.cpu_count() or 1))
            if len(paths) <= 4 * io_threads:
                # Small fof: chaining decode+sketch in one ~40ms task per
                # file leaves cores idle in the last wave (9 files / 4
                # cores = 3 uneven waves). Splitting each file into a
                # decode task and a sketch task (submitted when its decode
                # finishes) halves the task grain so the pool packs the
                # tail — measured 105 vs 119 ms on the 9-genome golden set.
                # Decoded-but-unsketched data is bounded by len(paths).
                out_futs = [Future() for _ in paths]
                with ThreadPoolExecutor(max_workers=io_threads) as pool:
                    def sketch_task(i, recs):
                        try:
                            out_futs[i].set_result(
                                self._host_sketch_whole(recs))
                        except BaseException as e:  # surface via result()
                            out_futs[i].set_exception(e)

                    def decode_task(i, pa):
                        try:
                            recs = self._load_packed(pa)
                            pool.submit(sketch_task, i, recs)
                        except BaseException as e:
                            out_futs[i].set_exception(e)
                    for i, pa in enumerate(paths):
                        pool.submit(decode_task, i, pa)
                    return [f.result() for f in out_futs]
            # Large fof: each file's load + whole-file sketch chains in one
            # pool task (decode ~230 Mbp/s/thread, staged sketcher ~250);
            # file-level parallelism already saturates the host, and at
            # most the pool's width of files is ever in flight.
            with ThreadPoolExecutor(max_workers=io_threads) as pool:
                futs = [pool.submit(
                    lambda pa=pa: self._host_sketch_whole(
                        self._load_packed(pa))) for pa in paths]
                return [f.result() for f in futs]
        from .ops.sketch import dispatch_sketch_packed_batch
        note("sketch:device", len(paths))
        p = self.params
        out: list = [None] * len(paths)
        io_threads = io_threads or min(8, os.cpu_count() or 1)
        # Small fofs run as ONE window: host decode of a few files is much
        # cheaper than the per-dispatch overhead another window would add,
        # and the device batch is bigger. Large fofs keep windowed overlap.
        # NIQKI_TPU_WINDOW overrides.
        env_w = os.environ.get("NIQKI_TPU_WINDOW")
        if env_w:
            window = max(1, int(env_w))
        elif len(paths) <= window:
            window = len(paths)
        pending = None

        def collect(pend) -> None:
            w0, rec_counts, batches = pend
            rows: dict[int, np.ndarray] = {}
            for chunk, dev in batches:
                host = np.asarray(dev)  # one d2h per batch
                for row, reci in enumerate(chunk):
                    rows[reci] = host[row]
            k = 0
            for fi, cnt in enumerate(rec_counts):
                out[w0 + fi] = self._finalize_tables(
                    [rows.get(k + ri) for ri in range(cnt)])
                k += cnt

        with ThreadPoolExecutor(max_workers=io_threads) as pool:
            def submit(w0):
                return (w0, [pool.submit(self._load_packed, pa)
                             for pa in paths[w0:w0 + window]])

            sub = submit(0) if paths else None
            while sub is not None:
                w0, futs = sub
                encs = [f.result() for f in futs]
                nxt = w0 + window
                sub = submit(nxt) if nxt < len(paths) else None
                records = [rec for recs in encs for rec in recs]
                batches = dispatch_sketch_packed_batch(records, p)
                dbg(f"window @{w0}: {len(encs)} files, {len(records)} "
                    f"records, {len(batches)} device batches")
                if pending is not None:
                    collect(pending)
                pending = (w0, [len(recs) for recs in encs], batches)
            if pending is not None:
                collect(pending)
        return out

    # ------------------------------------------------------------------
    # insertion
    def insert_sketch(self, sketch: np.ndarray, name: str) -> int:
        gid = len(self.names)
        self.names.append(name)
        self._rows.append(np.asarray(sketch, np.int32))
        self._device_mat = None
        self._device_planes = None
        self._sharded = None
        self._stored_host = None
        return gid

    def insert_file_whole(self, path: str, name: str | None = None) -> int:
        return self.insert_sketch(self.sketch_file(path), name or path)

    def _iter_packed_with_headers(self, path: str):
        """Yield (header, words, n_bases, exc_idx) per record of one file —
        a true stream: nothing beyond the current record is materialized."""
        p = self.params
        if native.available():
            yield from native.read_packed_records_chunked(path, p.K)
            return
        from .ops.sketch import pack_codes
        for h, s in read_records(path, p.K):
            yield (h, *pack_codes(*oracle.encode_record(s, p.K), p.K))

    def _load_packed_with_headers(self, path: str):
        """(header, words, n_bases, exc_idx) per record of one file."""
        return list(self._iter_packed_with_headers(path))

    # Lines-mode records are short reads: pad to 256-base buckets instead of
    # the whole-genome 2^14 floor (a 150 bp FASTQ read in a 16 kb row would
    # waste ~100x compute and transfer).
    LINES_MIN_PAD = 256

    def sketch_packed_records(self, packed_records,
                              min_pad: int = 1 << 14) -> list[np.ndarray]:
        """One finalized sketch (-1 empty) per packed (words, n, exc) record,
        batched: one transfer + one kernel per shape bucket."""
        p = self.params
        if not packed_records:
            return []
        from .ops.sketch import dispatch_sketch_packed_batch
        batches = dispatch_sketch_packed_batch(packed_records, p,
                                               min_pad=min_pad)
        return self._collect_packed(len(packed_records), batches)

    def _collect_packed(self, n: int, batches) -> list[np.ndarray]:
        out: list = [None] * n
        for chunk, dev in batches:
            host = np.asarray(dev)
            for row, i in enumerate(chunk):
                out[i] = self._finalize_tables([host[row]])
        for i, v in enumerate(out):  # records with no k-mers
            if v is None:
                out[i] = np.full(self.params.F, -1, np.int32)
        return out

    # Records at or below this many bases sketch on the HOST (native rolling
    # sketcher + densify on a thread pool): the device path pays a (F,)
    # table d2h PER RECORD plus dispatch overhead. Longer records (and the
    # whole-file path, one table per FILE) use the device kernel.
    HOST_SKETCH_MAX = 32768
    # Per-chunk base budget for the lines-mode streams (64 Mbp ≈ 16 MB
    # packed): the record-count bound alone would let chromosome-sized
    # records make a chunk arbitrarily large.
    CHUNK_BASES = 1 << 26

    def _host_sketch_packed(self, recs) -> list[np.ndarray]:
        """Finalized sketches (-1 sentinel) for short packed records via the
        native rolling CPU sketcher + densify, one C++ call for the whole
        group — bit-exact with the device kernel path."""
        p = self.params
        out = native.sketch_packed_batch(
            recs, p.lF, p.K, p.W, p.H, p.mask_M, p.maximal_remainder)
        return list(out)

    def _sketch_stream(self, rec_iter, chunk_records: int = 1 << 15):
        """Yield (records_chunk, sketches) pairs from a packed-record
        stream with one chunk of device read-ahead: chunk i+1's host read +
        dispatch overlaps chunk i's device execution. Peak memory is two
        chunks — never the whole file.

        Short records route to the host sketcher (see HOST_SKETCH_MAX);
        their sketches compute on a thread pool while the device works on
        the chunk's long records."""
        from .ops.sketch import dispatch_sketch_packed_batch
        host_max = int(os.environ.get("NIQKI_TPU_HOST_READS",
                                      self.HOST_SKETCH_MAX))
        if self._host_sketch_route():
            host_max = 1 << 62  # NIQKI_TPU_SKETCH=host: every record
        use_host = native.available()
        pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
        pending = None

        def take_chunk():
            # Chunks are bounded by BASES as well as records, so a lines
            # file of chromosome-sized records cannot blow up host memory
            # while read-sized records still batch wide (fewer dispatches).
            part, bases = [], 0
            for rec in rec_iter:
                part.append(rec)
                bases += rec[2]
                if len(part) >= chunk_records or bases >= self.CHUNK_BASES:
                    break
            return part

        try:
            while True:
                part = take_chunk()
                work = None
                if part:
                    recs = [r[1:] for r in part]
                    short = [i for i, r in enumerate(recs)
                             if use_host and r[1] <= host_max]
                    short_set = set(short)
                    long_recs = [(None, 0, None) if i in short_set else r
                                 for i, r in enumerate(recs)]
                    if len(short) < len(recs):
                        batches = dispatch_sketch_packed_batch(
                            long_recs, self.params,
                            min_pad=self.LINES_MIN_PAD)
                    else:
                        # All records route to the host sketcher: never
                        # touch the device dispatch (an all-short
                        # workload stays jax-free).
                        batches = []
                    grp = max(64, -(-len(short) // 32))
                    futs = [(short[lo:lo + grp], pool.submit(
                        self._host_sketch_packed,
                        [recs[i] for i in short[lo:lo + grp]]))
                        for lo in range(0, len(short), grp)]
                    work = (part, batches, futs)
                if pending is not None:
                    ppart, pbatches, pfuts = pending
                    if pbatches:
                        sks = self._collect_packed(len(ppart), pbatches)
                    else:  # all-short chunk: every row comes from the pool
                        sks = [None] * len(ppart)
                    for idxs, fut in pfuts:
                        for i, sk in zip(idxs, fut.result()):
                            sks[i] = sk
                    yield ppart, sks
                if not part:
                    return
                pending = work
        finally:
            pool.shutdown(wait=False)

    def insert_file_lines(self, path: str,
                          chunk_records: int = 1 << 15) -> list[int]:
        """Each record of the file becomes a separate entry named by its
        header line (including the '>'/'@' prefix). Device work is batched
        per ``chunk_records`` records, streamed with bounded memory."""
        if self.backend == "numpy":
            return [self.insert_sketch(self.sketch_records([s]), h)
                    for h, s in read_records(path, self.params.K)]
        gids = []
        for part, sks in self._sketch_stream(
                self._iter_packed_with_headers(path), chunk_records):
            gids.extend(self.insert_sketch(sk, r[0])
                        for r, sk in zip(part, sks))
        return gids

    # ------------------------------------------------------------------
    # the dense matrix
    @property
    def G(self) -> int:
        return len(self.names)

    def matrix(self) -> np.ndarray:
        if self._mat is None and self._mat_loader is not None:
            # mesh-direct load_sharded keeps the host matrix lazy: serving
            # only needs the device planes; dump()/matrix() pay on demand.
            self._mat, self._mat_loader = self._mat_loader(), None
        if self._mat is None or len(self._mat) != self.G:
            if self._rows:
                # Consolidate into a hugepage-backed destination: a plain
                # np.vstack first-touches GBs of fresh 4K pages, which this
                # class of virtualized host faults at ~22 MB/s (90+ s at
                # 100k genomes); hugepage faults run at 1.5+ GB/s.
                prev = self._mat if self._mat is not None else None
                n_prev = len(prev) if prev is not None else 0
                mat = hostmem.big_empty(
                    (n_prev + len(self._rows), self.params.F), np.int32)
                if n_prev:
                    mat[:n_prev] = prev
                for i, r in enumerate(self._rows):
                    mat[n_prev + i] = r
                self._mat = mat
                self._rows = []
            elif self._mat is None:
                self._mat = np.zeros((0, self.params.F), np.int32)
        return self._mat

    @property
    def _device_dtype(self):
        # Fingerprints are W-bit (< 2^14 at any supported W<=14) and the
        # empty sentinel is -1, so int16 halves device footprint and compare
        # bandwidth at identical counting results.
        return np.int16 if self.params.W <= 14 else np.int32

    def _stored(self) -> np.ndarray:
        """Count-side view of the matrix: fingerprints outside
        [0, 2^W) become -2 — the reference's insert_sketch never puts them
        in buckets (src/niqki_index.cpp:362-364: empty slots, and
        out-of-range values the -G stale constants can produce)."""
        mat = self.matrix()
        # Chunked copy into a hugepage destination: np.where would allocate
        # a fresh GB-scale result plus a bool temp, both first-touch-bound
        # on this host class (niqki_tpu/hostmem.py); block temps reuse the
        # allocator's warm pool.
        out = hostmem.big_empty(mat.shape, np.int32)
        hi_fp = self.params.fingerprint_range
        B = 1 << 14

        def fix(lo):
            blk = mat[lo:lo + B]
            dst = out[lo:lo + B]
            np.copyto(dst, blk)
            dst[(blk < 0) | (blk >= hi_fp)] = -2

        blocks = range(0, len(mat), B)
        if len(mat) > B:  # numpy releases the GIL on the copies/compares
            with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as ex:
                list(ex.map(fix, blocks))
        else:
            for lo in blocks:
                fix(lo)
        return out

    def _stored_cached(self) -> np.ndarray:
        """_stored() with a host-side cache (invalidated on insert): the
        host count route runs once per streamed chunk and must not
        re-materialize the (G, F) sanitized matrix every call."""
        if self._stored_host is None or len(self._stored_host) != self.G:
            self._stored_host = self._stored()
        return self._stored_host

    def _query_side(self, q: np.ndarray) -> np.ndarray:
        """Query-side sanitization: out-of-range query fingerprints scan no
        bucket in the reference (query_sketch range guard), so they map to
        -3 — matching neither valid fingerprints nor the stored -2."""
        bad = (q < 0) | (q >= self.params.fingerprint_range)
        return np.where(bad, -3, q)

    def _device_matrix(self):
        import jax.numpy as jnp
        if self._device_mat is None:
            self._device_mat = jnp.asarray(
                hostmem.big_copy(self._stored(), self._device_dtype))
        return self._device_mat

    # ------------------------------------------------------------------
    # querying
    def _sharded_for(self, mesh):
        """The ShardedIndex serving this index on ``mesh``, rebuilt on G
        change AND on mesh change: flipping NIQKI_TPU_MESH between calls in
        one process must not reuse a stale device layout (active_mesh
        caches one Mesh object per spec, so identity comparison suffices).
        Single source for the three mesh routes (counts, pretty_hits_batch,
        engine matrix self-join)."""
        if self._sharded is None or self._sharded.G != self.G \
                or self._sharded.mesh is not mesh:
            from .parallel.serving import ShardedIndex
            self._sharded = ShardedIndex(self, mesh)
        return self._sharded

    def counts(self, q_sketches: np.ndarray) -> np.ndarray:
        """Hit counts (Q, G) for a batch of query sketches (Q, F)."""
        raw = np.atleast_2d(np.asarray(q_sketches, np.int32))
        if self.G == 0:
            return np.zeros((len(raw), 0), np.int32)
        if self.backend == "numpy":
            q = self._query_side(raw)
            mat = self._stored()
            out = np.empty((len(q), self.G), np.int32)
            for i, row in enumerate(q):
                out[i] = (mat == row[None, :]).sum(axis=1, dtype=np.int32)
            return out
        # Multi-device: when a production mesh is active (NIQKI_TPU_MESH /
        # --mesh, or several GPUs), serve counts from the tp-row-sharded
        # ShardedIndex — identical results, sharding is a layout choice.
        mesh = maybe_active_mesh()
        if mesh is not None:
            note("count:mesh")
            return self._sharded_for(mesh).counts(self._query_side(raw))
        # Routing: SMALL indexes count on the host (the device call is pure
        # overhead for a (Q, F) transfer + dispatch against a handful of
        # rows); everything else is the bit-plane count (ops/bcount).
        # NIQKI_TPU_COUNT = auto|host|xla|bcount|bcount-interpret|jnp
        # (bcount: the GPU kernel, jnp: the plain formula, xla: the
        # unpacked int compare); NIQKI_TPU_HOST_COUNT_G bounds the auto
        # host route (default 2048).
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
        host_max_g = int(os.environ.get("NIQKI_TPU_HOST_COUNT_G", "2048"))
        if native.available() and (
                mode == "host" or (mode == "auto" and self.G <= host_max_g)):
            # Raw q (not _query_side): nq_count_eq applies the range guard
            # in C++, so no sanitized (Q, F) copy is ever materialized.
            note("count:host")
            return native.count_eq(np.ascontiguousarray(raw),
                                   self._stored_cached(),
                                   self.params.fingerprint_range)
        import jax.numpy as jnp
        from .ops import bcount
        p = self.params
        q = self._query_side(raw)
        if mode != "xla" and bcount.supported(p.F, p.W):
            impl = bcount.count_impl(mode)
            note("count:" + impl)
            # sanitized=True contract: _query_side mapped everything outside
            # [0, 2^W) to -3, so q is within [-3, 2^W) — bcount skips its
            # range pass on that promise (debug-checked under
            # NIQKI_TPU_DEBUG).
            return np.asarray(bcount.match_counts_planes(
                q, self._planes(), self.G, p.W, impl, sanitized=True))
        note("count:xla")
        from .ops.count import match_counts_blocked
        res = match_counts_blocked(
            jnp.asarray(q.astype(self._device_dtype)), self._device_matrix())
        return np.asarray(res)

    def _planes(self):
        """The index's device bit-planes, built on first use (dropped on
        insert)."""
        if self._device_planes is None:
            from .ops import bcount
            self._device_planes = bcount.build_index_planes(
                self._stored(), self.params.W, sanitized=True)
        return self._device_planes

    def _hits_fmt_cached(self):
        from . import native
        if self._hits_fmt is None or self._hits_fmt.G != self.G:
            self._hits_fmt = native.HitsFormatter(self.names, self.params.F,
                                                  self.params.min_score)
        return self._hits_fmt

    def _emit_sparse_rows(self, q, headers, vals, idx, over,
                          dense_fn) -> bytes:
        """Shared tail of the sparse hit paths (single-device and mesh):
        format the compacted (vals, idx) survivors, re-fetching rows whose
        survivor set overflowed the top-k cap via ``dense_fn(rows)`` —
        byte-identical with HitsFormatter.format(counts(q), headers)."""
        fmt = self._hits_fmt_cached()
        if not over.any():
            return fmt.format_sparse(vals, idx, headers)
        if over.mean() > 0.25:
            # Hit-saturated batch (e.g. short queries at tiny J, where most
            # of the index clears the threshold): per-row re-fetches would
            # cost more than one dense pass — take the dense path for the
            # whole batch, bounding the sparse path's worst case at ~1.3x
            # the legacy path (the discarded top-k).
            return fmt.format(dense_fn(q), headers)
        dense_rows = np.nonzero(over)[0]
        dense = dense_fn(q[dense_rows])
        parts, di = [], 0
        for r in range(len(q)):
            if over[r]:
                parts.append(fmt.format(dense[di:di + 1], [headers[r]]))
                di += 1
            else:
                parts.append(fmt.format_sparse(vals[r:r + 1], idx[r:r + 1],
                                               [headers[r]]))
        return b"".join(parts)

    def pretty_hits_batch(self, q_sketches: np.ndarray,
                          headers: list[str]) -> bytes | None:
        """Formatted pretty-hit rows for a query batch through the SPARSE
        device path: fused pack+count+top-k per block, so only surviving
        (count, gid) pairs cross d2h instead of a dense (Q, G) int32 block
        (115 MB per 288 queries at G=100k). Byte-identical with
        HitsFormatter.format(counts(q), headers): rows whose survivor set
        overflows the top-k cap (NIQKI_TPU_HITS_CAP, default 2048) are
        re-fetched dense. Under an active mesh the same contract is served
        by per-shard top-k with global gids (ShardedIndex.topk_counts) —
        no dense (Q, G) materialization on the multi-device path either.
        Returns None when the sparse path is not eligible (small G, no
        native lib, min_score == 0, non-bit-plane route) — callers fall
        back to dense counts."""
        from . import native
        from .ops import bcount
        p = self.params
        if (self.backend == "numpy" or not native.available()
                or p.min_score < 1 or not bcount.supported(p.F, p.W)):
            return None
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
        if mode not in ("auto", "bcount", "bcount-interpret", "jnp"):
            return None
        cap = min(self.G,
                  int(os.environ.get("NIQKI_TPU_HITS_CAP", "2048")))
        if cap < 1:
            # Empty index (G == 0) or cap disabled: the dense path serves
            # (a zero cap would also divide by zero in the mesh branch).
            return None
        raw = np.atleast_2d(np.asarray(q_sketches, np.int32))
        assert len(raw) == len(headers)
        mesh = maybe_active_mesh()
        if mesh is not None:
            sharded = self._sharded_for(mesh)
            q = self._query_side(raw)
            res = sharded.topk_counts(q, cap, p.min_score)
            if res is None:     # non-planes shard kernel: dense serves
                return None
            note("hits:sparse-mesh")
            vals, gids, shard_cap = res
            tp = vals.shape[1] // shard_cap
            shard_rows = sharded._Gp // tp
            if shard_cap < shard_rows:
                over = (vals.reshape(len(q), tp, shard_cap)[:, :, -1]
                        >= p.min_score).any(axis=1)
            else:
                over = np.zeros(len(q), bool)
            return self._emit_sparse_rows(q, headers, vals, gids, over,
                                          sharded.counts)
        # Remaining eligibility gates BEFORE sanitizing: _query_side
        # materializes a fresh (n, F) int32 copy, which at read-scale
        # chunks (32k x 32768) is GB-scale first-touch — pure waste on
        # every ineligible call (hostmem.py pathology).
        if self.G < 4096:
            return None
        impl = bcount.count_impl(mode)
        note("hits:sparse")
        note("count:" + impl)
        q = self._query_side(raw)
        xp = self._planes()
        vals, idx = bcount.match_counts_planes(
            q, xp, self.G, p.W, impl,
            sanitized=True, topk=cap, min_score=p.min_score)
        vals, idx = np.asarray(vals), np.asarray(idx)
        over = (vals[:, -1] >= p.min_score) if cap < self.G else \
            np.zeros(len(vals), bool)

        def dense_fn(qq):
            return np.asarray(bcount.match_counts_planes(
                qq, xp, self.G, p.W, impl, sanitized=True))

        return self._emit_sparse_rows(q, headers, vals, idx, over, dense_fn)

    def query_sketch_stream(self, rec_iter, chunk_records: int = 1 << 15):
        """Yield (records_chunk, stacked (n, F) int32 sketches) pairs from
        a packed-record stream, bounded memory."""
        for part, sks in self._sketch_stream(rec_iter, chunk_records):
            if not sks:
                yield part, np.zeros((0, self.params.F), np.int32)
                continue
            # Stack into a hugepage-backed buffer: np.stack of a 32k-read
            # chunk first-touches ~134 MB of fresh pages (~6-22 MB/s on
            # this host class; hostmem.py).
            q = hostmem.big_empty((len(sks), self.params.F), np.int32)
            for i, s in enumerate(sks):
                q[i] = s
            yield part, q

    def query_counts_stream(self, rec_iter, chunk_records: int = 1 << 15):
        """Yield (records_chunk, (n, G) counts) pairs from a packed-record
        stream, one batched count call per chunk, bounded memory."""
        for part, q in self.query_sketch_stream(rec_iter, chunk_records):
            yield part, (self.counts(q) if len(q)
                         else np.zeros((0, self.G), np.int32))

    def hits_from_counts(self, c: np.ndarray) -> list[tuple[int, int]]:
        return hits_from_counts(c, self.params.min_score)

    def hits(self, q_sketch: np.ndarray) -> list[tuple[int, int]]:
        return self.hits_from_counts(self.counts(q_sketch[None, :])[0])

    def all_vs_all_counts(self) -> np.ndarray:
        """(G, G) count matrix of the index against itself."""
        return self.counts(self.matrix())

    # ------------------------------------------------------------------
    # persistence: NIQKI-compatible dump/load
    def dump(self, path: str) -> None:
        save_dump(path, self.params, self.matrix(), self.names)

    @classmethod
    def load(cls, path: str, backend: str = "jax") -> "SketchIndex":
        hdr, mat, names = load_dump(path)
        idx = cls(hdr.params(), backend=backend)
        idx._mat = mat
        idx.names = list(names)
        return idx

    # ------------------------------------------------------------------
    # persistence: native sharded checkpoint (raw row blocks per genome
    # range; only the legacy v1 format was npz)
    def save_sharded(self, directory: str, num_shards: int = 1,
                     compress: bool = True, planes: bool = False) -> None:
        """Sharded checkpoint: raw little-endian int32 row blocks plus a
        newline-separated utf-8 name blob per shard (record names are
        single lines by construction). np.savez measured 20-30 MB/s on this
        class of virtual disk vs ~760 MB/s for plain writes; a 100k-genome
        matrix is GBs.

        planes=True (format v3) additionally persists each shard's
        (W+1, rows, F/32) uint32 bit-planes (host-packed, bit-identical
        with the device pack) so a serving restart
        (parallel.serving.ShardedIndex.from_checkpoint) can device_put
        shards directly without re-packing — 1.625 B/slot on disk vs the
        row block's 4, at +40% total checkpoint size."""
        os.makedirs(directory, exist_ok=True)
        mat = np.ascontiguousarray(self.matrix(), np.int32)
        bounds = np.linspace(0, self.G, num_shards + 1).astype(int)
        p = self.params
        manifest = {
            "format": "niqki_tpu.sharded.v3" if planes
            else "niqki_tpu.sharded.v2",
            "params": {"lF": p.lF, "K": p.K, "W": p.W, "H": p.H,
                       "min_fract": p.min_fract,
                       # -G stale fingerprint constants (None = H-derived):
                       # without them a reloaded -G index would sketch
                       # queries with different constants than its rows.
                       "stale_mask_M": p.stale_mask_M,
                       "stale_maximal_remainder": p.stale_maximal_remainder},
            "genomes": self.G,
            "compress": bool(compress),
            "shards": [],
        }

        def write_shard(s: int) -> dict:
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            fn = f"shard_{s:05d}.bin" + (".gz" if compress else "")
            if compress:
                with open(os.path.join(directory, fn), "wb") as f:
                    # one-shot zlib deflate in a gzip container: Python's
                    # streaming gzip.open writes measure ~20 MB/s here
                    co = zlib.compressobj(1, zlib.DEFLATED, 31)
                    f.write(co.compress(memoryview(mat[lo:hi])))
                    f.write(co.flush())
            else:
                # O_DIRECT when possible: buffered writes of GB shards run
                # at page-cache-population speed (~12 MB/s on this host
                # class) vs 0.5 GB/s direct (niqki_tpu/hostmem.py).
                hostmem.write_direct(os.path.join(directory, fn), mat[lo:hi])
            nf = f"shard_{s:05d}.names"
            with open(os.path.join(directory, nf), "wb") as f:
                f.write("\n".join(self.names[lo:hi]).encode())
            entry = {"file": fn, "names": nf, "lo": lo, "hi": hi}
            if planes:
                from .ops import bcount
                pf = f"planes_{s:05d}.bin"
                pk = bcount.np_pack_bitplanes(mat[lo:hi], p.W)
                hostmem.write_direct(os.path.join(directory, pf), pk)
                entry["planes"] = pf
            return entry

        # Shards save in parallel: the v3 plane pack is pure CPU (numpy,
        # GIL mostly released) and the row/plane writes are O_DIRECT, so
        # shard s+1's pack overlaps shard s's write — the serialized loop
        # was the measured wall of the 13 GB S=15 roundtrip.
        from concurrent.futures import ThreadPoolExecutor
        workers = min(num_shards, max(2, (os.cpu_count() or 2)))
        if num_shards == 1:
            manifest["shards"].append(write_shard(0))
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                manifest["shards"].extend(ex.map(write_shard,
                                                 range(num_shards)))
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load_sharded(cls, directory: str, backend: str = "jax",
                     mesh=None) -> "SketchIndex":
        """Load a sharded checkpoint. With ``mesh`` given, the serving path
        restarts MESH-DIRECT: each 'tp' shard's bit-planes go straight to
        their owning device (parallel.serving.ShardedIndex.from_checkpoint
        — no global host matrix), and the host row matrix stays lazy (only
        materialized if matrix()/dump() is actually called)."""
        import gzip as _gzip
        if mesh is not None:
            from .parallel.serving import ShardedIndex
            sharded = ShardedIndex.from_checkpoint(directory, mesh)
            idx = cls(sharded.params)
            idx.names = list(sharded.names)
            idx._sharded = sharded
            idx._mat_loader = lambda: cls.load_sharded(directory).matrix()
            return idx
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt not in ("niqki_tpu.sharded.v1", "niqki_tpu.sharded.v2",
                       "niqki_tpu.sharded.v3"):
            raise ValueError(f"unknown checkpoint format in {directory}")
        pp = manifest["params"]
        idx = cls(SketchParams(
            lF=pp["lF"], K=pp["K"], W=pp["W"], H=pp["H"],
            min_fract=pp["min_fract"],
            stale_mask_M=pp.get("stale_mask_M"),
            stale_maximal_remainder=pp.get("stale_maximal_remainder")),
            backend=backend)
        F = idx.params.F
        mat = hostmem.big_empty((manifest["genomes"], F), np.int32)
        shards = manifest["shards"]
        shard_names: list[list[str]] = [[] for _ in shards]

        def read_shard(s: int) -> None:
            sh = shards[s]
            path = os.path.join(directory, sh["file"])
            lo, hi = sh["lo"], sh["hi"]
            if fmt == "niqki_tpu.sharded.v1":   # legacy npz checkpoints
                z = np.load(path, allow_pickle=True)
                mat[lo:hi] = z["sketches"]
                shard_names[s] = z["names"].tolist()
                return
            if sh["file"].endswith(".gz"):
                with open(path, "rb") as f:      # one-shot inflate (see save)
                    raw = zlib.decompress(f.read(), 31)
                mat[lo:hi] = np.frombuffer(raw, np.int32).reshape(hi - lo, F)
            else:
                hostmem.read_direct(path, mat[lo:hi])
            with open(os.path.join(directory, sh["names"]), "rb") as f:
                blob = f.read().decode()
            shard_names[s] = blob.split("\n") if hi > lo else []

        # Parallel shard reads (O_DIRECT preads / inflates release the GIL);
        # name order is reassembled by shard rank, so ids stay identical
        # with the sequential loader.
        from concurrent.futures import ThreadPoolExecutor
        if len(shards) <= 1:
            for s in range(len(shards)):
                read_shard(s)
        else:
            workers = min(len(shards), max(2, (os.cpu_count() or 2)))
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(read_shard, range(len(shards))))
        idx._mat = mat
        idx.names = [n for ns in shard_names for n in ns]
        return idx
