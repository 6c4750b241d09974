"""File-level drivers: the reference CLI's insert/query/matrix behaviors.

Mirrors the control flow of /root/reference/src/niqki.cpp:229-456 and the
file-of-files drivers in /root/reference/src/niqki_index.cpp:383-540,614-743,
including the path-resolution quirks that matter for output parity:

  * -I/-i/-M resolve fof entries relative to the fof's own directory;
  * -Q/-l resolve fof entries relative to the CWD (no chdir);
  * genome names in outputs are the fof lines exactly as written;
  * missing fof entries are silently skipped;
  * ids are assigned in fof line order (the reference is only deterministic
    single-threaded; we standardize on that order, which the golden fixtures
    use).
"""

from __future__ import annotations

import os

import numpy as np

from .debug import note
from .index import SketchIndex, maybe_active_mesh
from .io.fasta import exists, read_fof, read_query_fof, read_records
from .io.writers import (GzTextWriter, write_binary_hits, write_matrix_header,
                         write_matrix_row, write_pretty_hits)


def _fof_entries(fof_path: str):
    """Yield (name_as_written, resolved_path) for existing entries, resolving
    relative to the fof's directory (the -I/-M chdir behavior)."""
    base = os.path.dirname(os.path.abspath(fof_path))
    for line in read_fof(fof_path):
        path = line if os.path.isabs(line) else os.path.join(base, line)
        if exists(path):
            yield line, path


def insert_fof_whole(index: SketchIndex, fof_path: str) -> None:
    entries = list(_fof_entries(fof_path))
    sketches = index.sketch_files([p for _, p in entries])
    for (name, _), sk in zip(entries, sketches):
        index.insert_sketch(sk, name)


def insert_file_lines(index: SketchIndex, path: str) -> None:
    # -i also chdirs to the file's directory, but the file is opened there
    # under its basename, which resolves to the same file; nothing to adjust.
    index.insert_file_lines(path)


def _stack_sketches(sks) -> np.ndarray:
    """np.stack into a hugepage-backed destination: a 256-query S=15 chunk
    is ~33 MB of fresh first-touch pages on the plain-allocation path
    (niqki_tpu/hostmem.py pathology)."""
    from . import hostmem
    q = hostmem.big_empty((len(sks), len(sks[0])), np.int32)
    for i, s in enumerate(sks):
        q[i] = s
    return q


def query_fof_whole(index: SketchIndex, fof_path: str, out: GzTextWriter,
                    pretty: bool = True, batch: int | None = None) -> None:
    """-Q: each fof entry (resolved from CWD) is sketched whole and queried.

    PIPELINED: chunk i+1's sketching (host thread pool / device batches)
    overlaps chunk i's hit counting (device kernel + wire) and output
    formatting — the two phases consume disjoint resources, so the e2e
    wall approaches max(sketch, count) instead of their sum. Output rows
    stream in fof order. The default batch is ops.bcount.BLOCK_Q: one
    count dispatch per chunk, fine-grained enough that the count/format of
    chunk i hides under chunk i+1's sketching.
    """
    if batch is None:
        from .ops.bcount import BLOCK_Q
        batch = BLOCK_Q
    lines = [ln for ln in read_query_fof(fof_path) if exists(ln)]
    chunks = [lines[lo:lo + batch] for lo in range(0, len(lines), batch)]

    def process(chunk, sks):
        if pretty and sks:
            # sparse device path: fused pack+count+top-k ships only
            # surviving (count, gid) pairs (None -> not eligible)
            buf = index.pretty_hits_batch(_stack_sketches(sks), chunk)
            if buf is not None:
                out.write(buf)
                return
        counts = index.counts(_stack_sketches(sks)) if sks else []
        for name, c in zip(chunk, counts):
            hits = index.hits_from_counts(c)
            if pretty:
                write_pretty_hits(out, name, hits, index.names,
                                  index.params.F)
            else:
                write_binary_hits(out, name, hits)

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pre:
        fut = pre.submit(index.sketch_files, chunks[0]) if chunks else None
        for i, chunk in enumerate(chunks):
            sks = fut.result()
            fut = pre.submit(index.sketch_files, chunks[i + 1]) \
                if i + 1 < len(chunks) else None
            process(chunk, sks)


def query_file_lines(index: SketchIndex, path: str, out: GzTextWriter,
                     pretty: bool = True, batch: int = 1 << 15) -> None:
    """-l: each record of the file is a separate query named by its header.

    Records are sketched in device batches and counted in one blocked device
    call per batch; rows stream in file order.
    """
    if index.backend == "numpy":
        for header, seq in read_records(path, index.params.K):
            hits = index.hits(index.sketch_records([seq]))
            if pretty:
                write_pretty_hits(out, header, hits, index.names,
                                  index.params.F)
            else:
                write_binary_hits(out, header, hits)
        return
    # Streamed with bounded memory (two record chunks in flight); on a
    # device backend the whole chunk fuses sketch+densify+count on device
    # and only (n, G) counts come back. Rows stream in file order. Pretty
    # rows format natively per chunk (hit extraction + %.6g of a 32k-read
    # block measured ~1.5s of Python per 100k reads).
    # The chunk's (batch, G) counts block lives on device (and crosses
    # d2h): at big G a 32k-record chunk is a multi-GB allocation (32k x
    # 100k int32 = 13 GB), so halve the chunk until batch * G stays within
    # ~1 GB of int32.
    while batch > (1 << 11) and batch * max(index.G, 1) > (1 << 28):
        batch //= 2
    from . import native
    from .index import hits_from_counts_batch
    fmt = None
    if pretty and native.available():
        fmt = native.HitsFormatter(index.names, index.params.F,
                                   index.params.min_score)
    for part, q in index.query_sketch_stream(
            index._iter_packed_with_headers(path), batch):
        headers = [r[0] for r in part]
        if fmt is not None and len(q):
            # sparse top-k device path when eligible: survivors-only d2h
            # instead of the dense (n, G) counts block (the wall at big G)
            buf = index.pretty_hits_batch(q, headers)
            if buf is None:
                buf = fmt.format(index.counts(q), headers)
            out.write(buf)
            continue
        counts = index.counts(q) if len(q) else \
            np.zeros((0, index.G), np.int32)
        all_hits = hits_from_counts_batch(counts, index.params.min_score)
        for r, hits in zip(part, all_hits):
            if pretty:
                write_pretty_hits(out, r[0], hits, index.names,
                                  index.params.F)
            else:
                write_binary_hits(out, r[0], hits)


def _matrix_selfjoin_mode(index: SketchIndex) -> bool:
    """Route the all-vs-all through the device self-join when the index
    bit-planes + native formatter are usable (NIQKI_TPU_MATRIX=
    auto|selfjoin|dense; auto takes the self-join at G >= 2048, where the
    legacy path's (batch, G) host counts + Python row formatting stop
    scaling)."""
    from . import native
    from .ops import bcount
    mode = os.environ.get("NIQKI_TPU_MATRIX", "auto")
    if mode == "dense":
        return False
    p = index.params
    ok = (index.backend != "numpy" and native.available()
          and bcount.supported(p.F, p.W))
    if mode == "selfjoin":
        if not ok:
            raise RuntimeError("NIQKI_TPU_MATRIX=selfjoin needs a device "
                               "backend, the native lib, and the bit-plane "
                               "count's shape gate (F%32==0, 1<=W<=30)")
        return True
    return ok and index.G >= 2048


def _query_matrix_selfjoin_mesh(index: SketchIndex, out: GzTextWriter,
                                mesh) -> bool:
    """All-vs-all under an active mesh: each block of B global rows is
    sliced out of the tp-sharded planes ON DEVICE (masked gather + psum —
    zero query h2d), counted per shard, uint16-wrapped, and per-shard
    top-k compacted with global gids (parallel.sharded.sharded_selfjoin);
    only survivors cross d2h, exactly like the single-device self-join.
    Returns False when the mesh index doesn't route the planes kernel
    (callers fall back to the dense loop)."""
    import numpy as np
    from . import native
    from .ops import bcount
    p = index.params
    sharded = index._sharded_for(mesh)
    if sharded._kernel != "planes":
        return False
    note("matrix:selfjoin-mesh")
    G, Gp = index.G, sharded._Gp
    B = min(bcount.MATRIX_BLOCK, Gp)
    cap = min(Gp, int(os.environ.get("NIQKI_TPU_MATRIX_CAP", "1024")))
    sparse = p.min_score > 0
    fmt = native.MatrixFormatter(index.names, p.F, p.min_score)

    starts = []
    for lo in range(0, G, B):
        start = max(0, min(lo, Gp - B))
        starts.append((lo, start, lo - start, min(B - (lo - start), G - lo)))

    def fetch(i):
        lo, start, off, n = starts[i]
        if not sparse:
            return sharded.selfjoin_block(start, B, None, 0)
        return sharded.selfjoin_block(start, B, cap, p.min_score)

    # Fetch-ahead-by-1 on a thread: block i+1's shard kernels + cross-shard
    # gather + d2h run while block i's survivors format/write on the host —
    # the same overlap the single-device self-join uses. selfjoin_
    # block is self-contained (compiled-fn cache + materialization), so one
    # background fetcher keeps ordering without touching shared state.
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as fetcher:
        pending = fetcher.submit(fetch, 0) if starts else None
        for i, (lo, start, off, n) in enumerate(starts):
            res = pending.result()
            pending = fetcher.submit(fetch, i + 1) \
                if i + 1 < len(starts) else None
            if not sparse:
                out.write(fmt.format_dense(res[off:off + n, :G], lo))
                continue
            vals, gids, shard_cap = res
            vals, gids = vals[off:off + n], gids[off:off + n]
            tp = vals.shape[1] // shard_cap
            if shard_cap < Gp // tp and \
                    (vals.reshape(n, tp, shard_cap)[:, :, -1]
                     >= p.min_score).any():
                # some shard's row hit its cap: re-fetch the block dense
                c = sharded.selfjoin_block(start, B, None, 0)
                out.write(fmt.format_dense(c[off:off + n, :G], lo))
            else:
                out.write(fmt.format_sparse(vals, gids, lo))
    return True


class _ParallelMatrixFmt:
    """Row-chunked parallel front for native.MatrixFormatter: the C++
    formatter releases the GIL, and at G=102400 one 1024-row block is
    ~250 MB of row text, which one core formats too slowly to hide under
    the device sweep. Each worker owns its own
    formatter (the native _FmtBuf output buffer is not shareable); chunks
    write to ``out`` strictly in row order."""

    def __init__(self, names, F: int, min_score: int, threads: int = 4):
        from . import native
        self._fmts = [native.MatrixFormatter(names, F, min_score)
                      for _ in range(threads)]
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(threads)
        self.min_score = min_score

    def write_sparse(self, out, vals, idx, row0: int) -> None:
        n = len(vals)
        if n <= 96:
            out.write(self._fmts[0].format_sparse(vals, idx, row0))
            return
        k = len(self._fmts)
        chunk = -(-n // k)
        futs = [self._pool.submit(self._fmts[t].format_sparse,
                                  vals[t * chunk:(t + 1) * chunk],
                                  idx[t * chunk:(t + 1) * chunk],
                                  row0 + t * chunk)
                for t in range(k) if t * chunk < n]
        for f in futs:
            out.write(f.result())

    def write_dense(self, out, counts, row0: int) -> None:
        n = len(counts)
        if n <= 96:
            out.write(self._fmts[0].format_dense(counts, row0))
            return
        k = len(self._fmts)
        chunk = -(-n // k)
        futs = [self._pool.submit(self._fmts[t].format_dense,
                                  counts[t * chunk:(t + 1) * chunk],
                                  row0 + t * chunk)
                for t in range(k) if t * chunk < n]
        for f in futs:
            out.write(f.result())

    def close(self):
        self._pool.shutdown()


def _query_matrix_selfjoin_sym(index: SketchIndex, out: GzTextWriter,
                               xp, impl: str) -> None:
    """Symmetric (triangular) all-vs-all sweep — each unordered pair is
    counted ON DEVICE exactly once and the strictly-lower half is recovered
    by HOST-side mirroring (equality counts are symmetric: counts[a,b] ==
    counts[b,a], and the uint16 wrap preserves that).

    Per block i of B rows, the device counts rows [iB, iB+B) only against
    the column window [iB, iB+wB) (ops.bcount._self_join_window_topk; w is
    the remaining block count quantized up to a NIQKI_TPU_MATRIX_QB
    multiple so the sweep compiles O(N/QB) shapes, padding columns are
    never-matching rows). Survivors ship compacted; the host then
    1) extracts each survivor (r, g) with g >= (i+1)B as a MIRROR entry
       (row g, col r) pending for block g//B, and
    2) emits block i's rows by merging its pending mirrors (all cols < iB,
       contributed by earlier blocks) with its shipped window survivors
       (cols >= iB; the diagonal tile carries both orientations of
       within-block pairs directly, so no within-block mirroring).

    Rows whose shipped top-k overflowed its cap re-fetch dense per
    BLOCK_Q sub-block (not per whole block), print dense, and rebuild
    their mirror contributions from the dense row (their shipped survivor
    set was truncated, so later rows would otherwise miss mirrors).
    Byte-identical with the full-sweep and dense paths
    (tests/test_matrix_selfjoin.py); replaces the reference's full G x G
    query_range sweep (/root/reference/src/niqki_index.cpp:570-610). The
    count, top_k and survivor d2h all scale with the window, so the device
    work halves over the sweep."""
    import numpy as np
    from . import native
    from .ops import bcount
    p = index.params
    min_score = p.min_score
    G, Gp = index.G, xp.shape[1]
    B = min(int(os.environ.get("NIQKI_TPU_MATRIX_BLOCK",
                               bcount.MATRIX_BLOCK)), Gp)
    QB = max(1, int(os.environ.get("NIQKI_TPU_MATRIX_QB", "8")))
    N = -(-Gp // B)
    cap = min(Gp, int(os.environ.get("NIQKI_TPU_MATRIX_CAP", "1024")))
    Gtot = (N + QB - 1) * B
    xpe = bcount.extend_planes(xp, Gtot - Gp)
    widths = [min(N, -(-(N - i) // QB) * QB) for i in range(N)]
    fmt = _ParallelMatrixFmt(index.names, p.F, min_score)
    sfmt = native.MatrixFormatter(index.names, p.F, min_score)
    # pending[j]: mirror entries for block j — (global rows, cols, vals)
    pending: list[list] = [[] for _ in range(N)]
    asm: dict = {"v": None, "g": None}

    def dispatch(i):
        return bcount._self_join_window_topk(
            xpe, i * B, min_score, B=B, w=widths[i], cap=cap, impl=impl)

    def fetch(res):
        return np.asarray(res[0]), np.asarray(res[1])

    def add_mirrors(rows_glob, cols, vals, lo):
        """Entries (row, col) with col >= lo+B mirror to (col, row)."""
        sel = cols >= lo + B
        if not sel.any():
            return
        mr, mc, mv = cols[sel], rows_glob[sel], vals[sel]
        jblk = mr // B
        order = np.argsort(jblk, kind="stable")
        mr, mc, mv, jblk = mr[order], mc[order], mv[order], jblk[order]
        bounds = np.searchsorted(jblk, np.arange(N + 1))
        for j in range(int(jblk[0]), int(jblk[-1]) + 1):
            a, b = bounds[j], bounds[j + 1]
            if a < b:
                pending[j].append((mr[a:b], mc[a:b], mv[a:b]))

    def emit(i, vals, gids):
        lo = i * B
        n = min(B, G - lo)
        vals, gids = vals[:n], gids[:n]
        cap_eff = vals.shape[1]
        over = (vals[:, -1] >= min_score) if cap_eff < widths[i] * B \
            else np.zeros(n, bool)
        keep = vals >= min_score
        dense_rows: dict[int, np.ndarray] = {}
        if over.any():
            keep[over] = False   # overflow rows emit + mirror from dense
            for s in np.unique(np.nonzero(over)[0] // bcount.BLOCK_Q):
                start = lo + int(s) * bcount.BLOCK_Q
                d = np.asarray(bcount._self_join_dense(
                    xpe, start, B=bcount.BLOCK_Q,
                    impl=impl))[:, :Gp].astype(np.int32)
                for r in np.nonzero(over)[0]:
                    if int(r) // bcount.BLOCK_Q == int(s):
                        dense_rows[int(r)] = d[int(r) - int(s) * bcount.BLOCK_Q]
            for r, drow in dense_rows.items():
                dcols = np.nonzero(drow >= min_score)[0]
                add_mirrors(np.full(len(dcols), lo + r), dcols,
                            drow[dcols].astype(np.int32), lo)
        # shipped survivors (non-overflow rows)
        rr, kk = np.nonzero(keep)
        s_rows, s_cols, s_vals = rr.astype(np.int64), gids[rr, kk], \
            vals[rr, kk]
        add_mirrors(lo + s_rows, s_cols, s_vals, lo)
        # assemble rows: pending mirrors (cols < lo) + shipped (cols >= lo)
        if pending[i]:
            pr = np.concatenate([t[0] for t in pending[i]]) - lo
            pc = np.concatenate([t[1] for t in pending[i]])
            pv = np.concatenate([t[2] for t in pending[i]])
            pending[i] = []
            a_rows = np.concatenate([pr, s_rows])
            a_cols = np.concatenate([pc, s_cols]).astype(np.int32)
            a_vals = np.concatenate([pv, s_vals]).astype(np.int32)
        else:
            a_rows, a_cols, a_vals = s_rows, s_cols.astype(np.int32), \
                s_vals.astype(np.int32)
        order = np.argsort(a_rows, kind="stable")
        a_rows, a_cols, a_vals = a_rows[order], a_cols[order], a_vals[order]
        cnt = np.bincount(a_rows, minlength=n).astype(np.int64)
        lmax = max(int(cnt.max()) if n else 0, 1)
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(cnt, out=starts[1:])
        pos = np.arange(len(a_rows)) - starts[a_rows]
        # grow-only persistent assembly buffers: a fresh np.zeros per block
        # is ~10 MB of first-touch pages every block (hostmem pathology)
        if asm["v"] is None or asm["v"].shape[0] < n \
                or asm["v"].shape[1] < lmax:
            asm["v"] = np.zeros((B, max(lmax, 2 * cap)), np.int32)
            asm["g"] = np.zeros_like(asm["v"])
        av = asm["v"][:n, :lmax]
        ag = asm["g"][:n, :lmax]
        av[:] = 0
        ag[:] = 0
        av[a_rows, pos] = a_vals
        ag[a_rows, pos] = a_cols
        if not over.any():
            fmt.write_sparse(out, av, ag, lo)
            return
        # mixed emit: contiguous sparse runs + dense overflow rows, in order
        r = 0
        while r < n:
            if over[r]:
                c16 = dense_rows[r][None, :G].astype(np.uint16)
                out.write(sfmt.format_dense(c16, lo + r))
                r += 1
            else:
                e = r
                while e < n and not over[e]:
                    e += 1
                fmt.write_sparse(out, av[r:e], ag[r:e], lo + r)
                r = e

    # Dispatch-ahead-by-2 with threaded d2h, like the full-sweep path: the
    # dispatches are independent (no device state), so block i+1/i+2's
    # kernels and block i+1's d2h ride under block i's host mirror/format.
    import time as _time
    stats = {"wait": 0.0, "emit": 0.0, "disp": 0.0}
    t_start = _time.time()
    from concurrent.futures import ThreadPoolExecutor
    try:
        with ThreadPoolExecutor(1) as fetcher:
            inflight = [fetcher.submit(fetch, dispatch(i))
                        for i in range(min(2, N))]
            for i in range(N):
                t0 = _time.time()
                vals, gids = inflight.pop(0).result()
                stats["wait"] += _time.time() - t0
                if i + 2 < N:
                    t0 = _time.time()
                    d = dispatch(i + 2)
                    stats["disp"] += _time.time() - t0
                    inflight.append(fetcher.submit(fetch, d))
                t0 = _time.time()
                emit(i, vals, gids)
                stats["emit"] += _time.time() - t0
    finally:
        fmt.close()
    if os.environ.get("NIQKI_TPU_MATRIX_STATS"):
        import sys
        print(f"sym sweep: N={N} total {_time.time() - t_start:.1f}s "
              f"device-wait {stats['wait']:.1f}s "
              f"dispatch {stats['disp']:.1f}s emit {stats['emit']:.1f}s",
              file=sys.stderr, flush=True)


def _query_matrix_selfjoin(index: SketchIndex, out: GzTextWriter) -> bool:
    """All-vs-all with ZERO query h2d: the queries are the index, already
    resident as bit-planes, so each block is a device-side slice->requery
    conversion + count + uint16 wrap + top-k compaction; only surviving
    (count, gid) pairs cross d2h (min_score > 0), or (B, Gp) uint16 rows
    when min_score == 0 (every cell prints). Rows format natively
    (nq_format_matrix_*). Byte-identical with the legacy path (tested
    against the golden fixtures); replaces the reference's bucket sweep +
    row writer (/root/reference/src/niqki_index.cpp:570-610,747-763).
    Under an active mesh the block kernel is the tp-sharded self-join.
    Returns False when ineligible (callers take the dense loop)."""
    import numpy as np
    from . import native
    from .ops import bcount
    p = index.params
    mesh = maybe_active_mesh()
    if mesh is not None:
        return _query_matrix_selfjoin_mesh(index, out, mesh)
    impl = bcount.count_impl()
    note("count:" + impl)
    xp = index._planes()
    G, Gp = index.G, xp.shape[1]
    sparse = p.min_score > 0
    # Sparse rows take the SYMMETRIC triangular sweep by default (each
    # unordered pair counted on device once, host-side mirroring): the
    # count, top_k and survivor d2h all halve vs the full sweep. Both
    # sweeps are byte-identical; NIQKI_TPU_MATRIX_SYM=on|off|auto picks.
    # min_score == 0 always keeps the full sweep — every cell prints, so
    # the dense (B, Gp) d2h must cross regardless of symmetry.
    sym = os.environ.get("NIQKI_TPU_MATRIX_SYM", "auto")
    if sparse and sym in ("on", "auto"):
        note("matrix:selfjoin-sym")
        _query_matrix_selfjoin_sym(index, out, xp, impl)
        return True
    note("matrix:selfjoin-full")
    B = min(int(os.environ.get("NIQKI_TPU_MATRIX_BLOCK",
                               bcount.MATRIX_BLOCK)), Gp)
    cap = min(Gp, int(os.environ.get("NIQKI_TPU_MATRIX_CAP", "1024")))
    fmt = native.MatrixFormatter(index.names, p.F, p.min_score)
    # parallel row-chunked formatting (the C++ formatter releases the GIL)
    pfmt = _ParallelMatrixFmt(index.names, p.F, p.min_score)

    starts = []
    for lo in range(0, G, B):
        start = max(0, min(lo, Gp - B))
        starts.append((lo, start, lo - start, min(B - (lo - start), G - lo)))

    def dispatch(i):
        lo, start, off, n = starts[i]
        if sparse:
            return bcount._self_join_topk(xp, start, p.min_score, B=B,
                                          cap=cap, impl=impl)
        return bcount._self_join_dense(xp, start, B=B, impl=impl)

    def fetch(res):
        # The d2h is the blocking point (np.asarray), not the kernel —
        # materialize in a background thread so block i+1's transfer rides
        # the wire while block i formats/writes on the host.
        if sparse:
            return np.asarray(res[0]), np.asarray(res[1])
        return np.asarray(res)

    # Dispatch-ahead-by-2 with threaded d2h: block i+1/i+2's kernels AND
    # block i+1's device->host transfer run while block i's survivors
    # format on the host.
    import time as _time
    stats = {"wait": 0.0, "emit": 0.0, "disp": 0.0}
    ahead = max(1, int(os.environ.get("NIQKI_TPU_MATRIX_AHEAD", "2")))
    from concurrent.futures import ThreadPoolExecutor
    try:
        with ThreadPoolExecutor(1) as fetcher:
            pending = [fetcher.submit(fetch, dispatch(i))
                       for i in range(min(ahead, len(starts)))]
            for i, (lo, start, off, n) in enumerate(starts):
                t0 = _time.time()
                res = pending.pop(0).result()
                stats["wait"] += _time.time() - t0
                if i + ahead < len(starts):
                    t0 = _time.time()
                    d = dispatch(i + ahead)
                    stats["disp"] += _time.time() - t0
                    pending.append(fetcher.submit(fetch, d))
                t0 = _time.time()
                _emit_selfjoin_block(index, out, fmt, res, sparse, xp,
                                     starts[i], cap, impl, B=B, G=G,
                                     Gp=Gp, pfmt=pfmt)
                stats["emit"] += _time.time() - t0
    finally:
        pfmt.close()
    if os.environ.get("NIQKI_TPU_MATRIX_STATS"):
        import sys
        print(f"full sweep: blocks={len(starts)} "
              f"device-wait {stats['wait']:.1f}s "
              f"dispatch {stats['disp']:.1f}s emit {stats['emit']:.1f}s",
              file=sys.stderr, flush=True)
    return True


def _emit_selfjoin_block(index, out, fmt, res, sparse, xp, blk, cap, impl,
                         *, B, G, Gp, pfmt=None):
    # B/G/Gp come from the dispatching caller (not recomputed): a dense
    # re-fetch must use the exact block sizing the sparse pass used.
    import numpy as np
    from .ops import bcount
    p = index.params
    lo, start, off, n = blk
    if sparse:
        vals, idx = res
        vals, idx = vals[off:off + n], idx[off:off + n]
        over = (vals[:, -1] >= p.min_score) if cap < Gp \
            else np.zeros(n, bool)
        if not over.any():
            if pfmt is not None:
                pfmt.write_sparse(out, vals, idx, lo)
            else:
                out.write(fmt.format_sparse(vals, idx, lo))
            return
        # >= cap survivors in some row: re-fetch ONLY the BLOCK_Q
        # sub-blocks holding overflowing rows dense (re-counting all B rows
        # would make every block of a clustered input with cluster size >
        # cap pay a double count + a (B, Gp) d2h), then emit sparse runs
        # and dense rows interleaved in row order — byte-identical.
        over_rows = np.nonzero(over)[0]
        dense_rows: dict[int, np.ndarray] = {}
        for s in np.unique(over_rows // bcount.BLOCK_Q):
            want = lo + int(s) * bcount.BLOCK_Q
            sub = max(0, min(want, Gp - bcount.BLOCK_Q))
            d = np.asarray(bcount._self_join_dense(
                xp, sub, B=bcount.BLOCK_Q, impl=impl))[:, :G]
            for r in over_rows:
                if int(r) // bcount.BLOCK_Q == int(s):
                    dense_rows[int(r)] = d[lo + int(r) - sub]
        r = 0
        while r < n:
            if over[r]:
                out.write(fmt.format_dense(dense_rows[r][None, :], lo + r))
                r += 1
            else:
                e = r
                while e < n and not over[e]:
                    e += 1
                out.write(fmt.format_sparse(vals[r:e], idx[r:e], lo + r))
                r = e
    else:
        c = res[off:off + n, :G]
        if pfmt is not None:
            pfmt.write_dense(out, c, lo)
        else:
            out.write(fmt.format_dense(c, lo))


def query_matrix(index: SketchIndex, out: GzTextWriter,
                 batch: int = 10000) -> None:
    """All-vs-all: dense Jaccard matrix of the index against itself."""
    write_matrix_header(out, index.names)
    if index.G and _matrix_selfjoin_mode(index) \
            and _query_matrix_selfjoin(index, out):
        return
    note("matrix:dense")
    p = index.params
    mat = index.matrix()
    for lo in range(0, index.G, batch):
        hi = min(lo + batch, index.G)
        counts = index.counts(mat[lo:hi])
        # The reference's matrix path counts in uint16 regardless of F
        # (query_range, src/niqki_index.cpp:572), so counts wrap mod 2^16
        # when lF >= 16 — including a genome's self-count of F. Reproduce
        # the wrap before thresholding/printing (no-op for lF < 16).
        counts = counts & 0xFFFF
        for r in range(hi - lo):
            write_matrix_row(out, index.names[lo + r], counts[r].tolist(),
                             p.F, p.min_score)


def query_file_matrix(index: SketchIndex, path: str,
                      out: GzTextWriter) -> None:
    """One matrix-formatted row (no header) for a whole-file query — the
    reference's query_file_whole_matrix (src/niqki_index.cpp:702-717):
    query_sketch thresholding then a dense count/F row."""
    counts = index.counts(index.sketch_file(path)[None, :])[0]
    write_matrix_row(out, path, counts.tolist(), index.params.F,
                     index.params.min_score)


def query_fof_matrix(index: SketchIndex, fof_path: str, out: GzTextWriter,
                     batch: int = 256) -> None:
    """Matrix-formatted rows for external query files (reference's
    query_file_of_file_whole_matrix, src/niqki_index.cpp:721-743;
    unreachable from its CLI but part of the library surface). Entries
    resolve from the CWD via plain getline — no length filter, unlike
    insert fofs (the reference uses raw getline + exists_test here)."""
    write_matrix_header(out, index.names)
    entries = [ln for ln in read_query_fof(fof_path) if exists(ln)]
    for lo in range(0, len(entries), batch):
        chunk = entries[lo:lo + batch]
        sks = np.stack(index.sketch_files(chunk))
        counts = index.counts(sks)
        for name, row in zip(chunk, counts):
            write_matrix_row(out, name, row.tolist(), index.params.F,
                             index.params.min_score)
