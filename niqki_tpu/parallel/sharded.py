"""Sharded sketch + query pipelines over a ('dp', 'tp') mesh.

Multi-device replacements for the reference's OpenMP threading (SURVEY.md
§2.2):

  * DP   — query/ingest batches shard on 'dp' (threads pulling fof lines);
  * TP   — the index's genome-row axis shards on 'tp' (the shared bucket
           table + striped locks become per-shard dense matrices, merged by
           all_gather of count blocks);
  * SP/CP — sequences split into (K-1)-halo chunks sharded on 'tp'; each
           chunk sketches independently and a single lax.pmin merges the
           per-slot minima (min is commutative — no ring pass needed);
  * EP analog — batch insertion routes new rows to the owning 'tp' shard via
           masked local scatter after an all_gather (tokens-to-experts).

Everything here is shape-static and jit/shard_map composable; no locks, no
atomics, deterministic by construction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..params import SketchParams
from ..ops.sketch import make_sketcher, INT32_MAX
from ..ops.densify import densify_device


def chunk_codes(codes: np.ndarray, n_chunks: int, K: int):
    """Split a code array into n_chunks overlapping chunks of C + K codes
    (C = ceil(n_kmers / n_chunks)) plus per-chunk valid k-mer counts, so that
    chunk j produces k-mer positions [j*C, (j+1)*C) of the original sequence.

    Returns (chunks (n_chunks, C+K) uint8, n_valid (n_chunks,) int32).
    """
    n_kmers = max(len(codes) - K, 0)
    C = -(-max(n_kmers, 1) // n_chunks)
    out = np.zeros((n_chunks, C + K), dtype=np.uint8)
    nv = np.zeros(n_chunks, dtype=np.int32)
    for j in range(n_chunks):
        lo = j * C
        hi = min(lo + C + K, len(codes))
        if lo < len(codes):
            out[j, : hi - lo] = codes[lo:hi]
        nv[j] = min(max(n_kmers - lo, 0), C)
    return out, nv


def sharded_sketch_batch(p: SketchParams, mesh: Mesh, densify: bool = True):
    """Returns a jitted fn sketching a batch of chunked sequences.

    fn(fwd (Q, T, C+K) u8, rc (Q, T, C+K) u8, n_valid (Q, T) i32) -> (Q, F)
    int32 sketch tables (INT32_MAX empty; densified on device if requested).
    Q shards on 'dp', the chunk axis T on 'tp'.
    """
    sketcher = make_sketcher(p)

    def per_shard(fwd, rc, nv):
        # fwd: (Qs, Ts, C+K) on this device
        def one(fv, rv, n):
            return sketcher(fv, rv, n)
        tables = jax.vmap(jax.vmap(one))(fwd, rc, nv)   # (Qs, Ts, F)
        local = jnp.min(tables, axis=1)                  # merge local chunks
        merged = jax.lax.pmin(local, axis_name="tp")     # SP/CP collective
        if densify:
            merged = jax.vmap(lambda t: densify_device(t, lF=p.lF))(merged)
        return merged

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("dp", "tp", None), P("dp", "tp", None), P("dp", "tp")),
        out_specs=P("dp", None),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_count(mesh: Mesh):
    """Returns a jitted fn(q_sk (Q, F), index (G, F)) -> counts (Q, G) with
    queries sharded on 'dp', index rows on 'tp', output sharded on both."""

    def per_shard(q, g):
        return jnp.sum((q[:, None, :] == g[None, :, :]), axis=-1,
                       dtype=jnp.int32)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("dp", None), P("tp", None)),
        out_specs=P("dp", "tp"),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_count_planes(mesh: Mesh, impl: str):
    """Bit-plane count (ops/bcount, implementation ``impl``) under
    shard_map: the production multi-device query kernel.

    Returns a jitted fn(qp (P, Q, L), xp (P, Gp, L)) -> counts (Q, Gp) with
    the query axis sharded on 'dp', index rows on 'tp', output on both.
    Q must be a dp*BLOCK_Q multiple and Gp a tp*TILE_G multiple (callers pad
    with the never-matching sentinel planes).
    """
    from ..ops.bcount import _count

    def per_shard(qp, xp):
        return _count(qp, xp, impl)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, "dp", None), P(None, "tp", None)),
        out_specs=P("dp", "tp"),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_count_planes_topk(mesh: Mesh, *, cap: int, impl: str,
                              wrap16: bool = False):
    """Per-shard bit-plane count + per-shard top-k compaction: the
    multi-device SPARSE hit path. Each 'tp' shard counts its index rows,
    takes its own top-``cap`` survivors, and rewrites local row ids to
    GLOBAL gids — so only (count, gid) candidates cross the device->host
    boundary, never a dense (Q, G) block (index.pretty_hits_batch).

    Returns a jitted fn(qp (P, Q, L), xp (P, Gp, L), min_score scalar) ->
    (vals, gids), each (Q, tp*cap) int32: shard s owns columns
    [s*cap, (s+1)*cap), count-descending within its block, sub-threshold
    entries masked to (0, 0) on device (the native formatters sort/merge
    survivors themselves). Q must be a dp*BLOCK_Q multiple; a row
    overflows shard s iff its column s*cap + cap - 1 is still >=
    min_score. ``wrap16`` wraps counts mod 2^16 first (the reference's
    uint16 matrix counters, niqki_index.cpp:572)."""
    from ..ops.bcount import _count, _mask_topk

    def per_shard(qp, xp, min_score):
        c = _count(qp, xp, impl)
        if wrap16:
            c = c & 0xFFFF
        vals, idx = jax.lax.top_k(c, min(cap, c.shape[1]))
        gids = idx + jax.lax.axis_index("tp") * c.shape[1]
        return _mask_topk(vals, gids, min_score)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, "dp", None), P(None, "tp", None), P()),
        out_specs=(P("dp", "tp"), P("dp", "tp")),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_selfjoin(mesh: Mesh, *, B: int, cap: int | None, impl: str):
    """All-vs-all self-join block under the mesh with ZERO query h2d: the
    query block is B consecutive GLOBAL index rows, sliced out of the
    tp-sharded planes by a masked gather + psum (each row is owned by
    exactly one shard, so the sum reconstructs it bit-exactly), converted
    to query planes on device, counted per shard, uint16-wrapped, and —
    when ``cap`` is set — per-shard top-k compacted with global gids like
    sharded_count_planes_topk. The multi-device twin of
    ops/bcount._self_join_topk/_self_join_dense.

    Returns fn(xp (P, Gp, L), lo scalar, min_score scalar) ->
      cap set:  (vals, gids) each (B, tp*cap) int32
      cap None: dense (B, Gp) uint16 wrapped counts (min_score ignored)
    Callers must keep [lo, lo+B) inside [0, Gp) (same clamped `starts`
    logic as the single-device path): every query row must be owned, or a
    zero-filled plane row would alias fingerprint 0."""
    from ..ops.bcount import _count, _mask_topk

    def per_shard(xp, lo, min_score):
        P_, Gs, L = xp.shape
        tp_id = jax.lax.axis_index("tp")
        ids = lo - tp_id * Gs + jnp.arange(B, dtype=jnp.int32)
        own = (ids >= 0) & (ids < Gs)
        rows = jnp.take(xp, jnp.clip(ids, 0, Gs - 1), axis=1)  # (P, B, L)
        rows = jnp.where(own[None, :, None], rows, jnp.uint32(0))
        qs = jax.lax.psum(rows, axis_name="tp")
        # stored planes -> query planes (see bcount._planes_as_queries)
        qp = jnp.concatenate([qs[:P_ - 1] | qs[P_ - 1:], qs[P_ - 1:]],
                             axis=0)
        c = _count(qp, xp, impl)
        c = c & 0xFFFF   # reference uint16 matrix counters
        if cap is None:
            return c.astype(jnp.uint16)
        vals, idx = jax.lax.top_k(c, min(cap, Gs))
        gids = idx + tp_id * Gs
        return _mask_topk(vals, gids, min_score)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(None, "tp", None), P(), P()),
        out_specs=P(None, "tp") if cap is None
        else (P(None, "tp"), P(None, "tp")),
        check_vma=False,
    )
    return jax.jit(fn)


def chunk_packed(words: np.ndarray, n_bases: int, exc: np.ndarray,
                 n_chunks: int, K: int):
    """Split one record's 2-bit packed wire form into n_chunks overlapping
    chunks on word boundaries (the SP/CP sharding of the production ingest
    step — 4x less transfer than chunking the unpacked uint8 codes).

    Chunk j produces k-mer positions [j*C, (j+1)*C) of the record; C is the
    per-chunk k-mer capacity rounded up to a 16-base word multiple so chunk
    starts stay word-aligned. Exceptions are remapped to chunk-local
    positions (EXC_PAD padding).

    Returns (chunk_words (T, Wc) uint32, n_valid (T,) int32,
             exc_local (T, E) int32).
    """
    from ..ops.sketch import EXC_PAD
    n_kmers = max(n_bases - K, 0)
    C = -(-max(n_kmers, 1) // n_chunks)
    C = -(-C // 16) * 16                       # word-aligned chunk starts
    Wc = (C + K + 15) // 16
    out_w = np.zeros((n_chunks, Wc), np.uint32)
    nv = np.zeros(n_chunks, np.int32)
    exc = np.asarray(exc, np.int32)
    loc: list[np.ndarray] = []
    for j in range(n_chunks):
        lo = j * C                             # first base of the chunk
        w0 = lo // 16
        if w0 < len(words):
            span = words[w0:w0 + Wc]
            out_w[j, :len(span)] = span
        nv[j] = min(max(n_kmers - lo, 0), C)
        e = exc[(exc >= lo) & (exc < lo + C + K)] - lo
        loc.append(e)
    E = max(8, 1 << (max((len(e) for e in loc), default=1) - 1).bit_length()) \
        if any(len(e) for e in loc) else 8
    out_e = np.full((n_chunks, E), EXC_PAD, np.int32)
    for j, e in enumerate(loc):
        out_e[j, :len(e)] = e
    return out_w, nv, out_e


def make_ingest_step_packed(p: SketchParams, mesh: Mesh):
    """The production fused multi-chip step on the 2-bit packed wire format:
    SP-chunked sketch (+pmin merge), on-device densify, EP-routed insert into
    the tp-sharded index, and a DPxTP count of the batch against the updated
    index. Jit-compatible, shape-static, no locks.

    fn(words (Q,T,Wc) u32, nv (Q,T) i32, exc (Q,T,E) i32, index (G,F) i32,
       g0 scalar) -> (new_index (G,F), counts (Q,G))
    """
    from ..ops.sketch import _sketch_packed_core

    def sketch_one(w, n, e):
        return _sketch_packed_core(
            w, n, e, lF=p.lF, K=p.K, W=p.W, H=p.H,
            mask_M=p.mask_M, max_rem=p.maximal_remainder)

    def step(words, nv, exc, index, g0):
        tp_id = jax.lax.axis_index("tp")

        tables = jax.vmap(jax.vmap(sketch_one))(words, nv, exc)  # (Qs,Ts,F)
        local = jnp.min(tables, axis=1)
        merged = jax.lax.pmin(local, axis_name="tp")
        merged = jax.vmap(lambda t: densify_device(t, lF=p.lF))(merged)

        # EP-style routed insert (same routing rule as make_ingest_step).
        all_sk = jax.lax.all_gather(merged, "dp", axis=0, tiled=True)
        Q = all_sk.shape[0]
        Gs = index.shape[0]
        gpos = g0 + jnp.arange(Q, dtype=jnp.int32)
        lpos = gpos - tp_id * Gs
        lpos = jnp.where((lpos >= 0) & (lpos < Gs), lpos, Gs)
        index = index.at[lpos].set(all_sk, mode="drop")

        counts = jnp.sum(
            (merged[:, None, :] == index[None, :, :]), axis=-1,
            dtype=jnp.int32)
        return index, counts

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P("dp", "tp", None), P("dp", "tp"), P("dp", "tp", None),
                  P("tp", None), P()),
        out_specs=(P("tp", None), P("dp", "tp")),
        check_vma=False,
    )
    return jax.jit(fn)


def make_ingest_step(p: SketchParams, mesh: Mesh):
    """The engine's full 'training step': sketch an ingest batch (SP over
    chunks), insert it into the sharded index at rows [g0, g0+Q) (EP-style
    routing to the owning 'tp' shard), and count the batch against the
    updated index (DP x TP). Jit-compatible, shape-static.

    fn(fwd (Q,T,C+K), rc, n_valid (Q,T), index (G,F), g0 scalar)
        -> (new_index (G,F), counts (Q,G))
    """
    sketcher = make_sketcher(p)

    def step(fwd, rc, nv, index, g0):
        tp_id = jax.lax.axis_index("tp")

        # --- sketch local batch shard (Qs, Ts, C+K) -> (Qs, F)
        tables = jax.vmap(jax.vmap(sketcher))(fwd, rc, nv)
        local = jnp.min(tables, axis=1)
        merged = jax.lax.pmin(local, axis_name="tp")
        merged = jax.vmap(lambda t: densify_device(t, lF=p.lF))(merged)

        # --- EP-style insert: gather the dp-sharded batch, route rows to the
        # owning index shard by global row id.
        all_sk = jax.lax.all_gather(merged, "dp", axis=0, tiled=True)  # (Q,F)
        Q = all_sk.shape[0]
        Gs = index.shape[0]                     # local rows per tp shard
        shard_lo = tp_id * Gs
        gpos = g0 + jnp.arange(Q, dtype=jnp.int32)          # global rows
        lpos = gpos - shard_lo
        # Rows owned by other shards are remapped to index Gs (out of range,
        # positive — negative indices would wrap) so mode="drop" discards
        # them: no read-modify-write races, fully vectorized.
        lpos = jnp.where((lpos >= 0) & (lpos < Gs), lpos, Gs)
        index = index.at[lpos].set(all_sk, mode="drop")

        # --- count the local query block against the local index shard
        counts = jnp.sum(
            (merged[:, None, :] == index[None, :, :]), axis=-1,
            dtype=jnp.int32)
        return index, counts

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P("dp", "tp", None), P("dp", "tp", None), P("dp", "tp"),
                  P("tp", None), P()),
        out_specs=(P("tp", None), P("dp", "tp")),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_index(index_mat: np.ndarray, mesh: Mesh):
    """Place a (G, F) index matrix row-sharded over 'tp', replicated on 'dp'."""
    return jax.device_put(index_mat, NamedSharding(mesh, P("tp", None)))
