"""Bit-plane fingerprint-match count — 32 compares per 32-bit word.

The index is stored bit-sliced: plane p of X holds bit p of every
fingerprint, packed 32 fingerprints per uint32 lane, plus one validity
plane. Equality over all W+1 planes is then

    match = AND_p XNOR(Qp[p], Xp[p])        (one bit per fingerprint)
    counts[q, g] = sum_lanes popcount(match)

i.e. about W+1 three-input logic ops plus a popcount per 32 fingerprint
compares, over (W+1)/32 of the bytes of an int32 fingerprint matrix.

Counts are exactly the reference's posting-list scan results
(/root/reference/src/niqki_index.cpp:633-687): the sentinel plane makes
stored-empty (-2) and query-invalid (-3) slots match nothing, including each
other (their value planes are complementary constants).

Two implementations of the one formula, chosen by ``count_impl``:

  ``pallas``  a Pallas kernel through Triton for the GPU: grid over
              (query tiles, index-row tiles), the lane axis a loop inside
              the block, each index tile loaded once per lane chunk and
              reused across the whole query tile, int32 accumulator in
              registers. ``pallas-interpret`` runs it through the Pallas
              interpreter (tests; never chosen implicitly).
  ``jnp``     the same formula in plain jax.numpy, which XLA fuses into one
              reduction; it serves the CPU backend and is the reference
              the kernel is timed against.

Every count is an integer and every comparison is exact equality: no
floating-point operation appears on either path.

Constraints: F % 32 == 0 (F = 2^lF, so lF >= 5) and 1 <= W <= 30.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Kernel tiling (powers of two, as Triton requires). Index rows are padded
# to a TILE_G multiple and every dispatch carries a BLOCK_Q multiple of
# queries, so the kernel never sees a ragged tile.
TILE_Q = 16         # queries per kernel block
TILE_G = 64         # index rows per kernel block (row padding multiple)
CHUNK_LANES = 8     # packed lanes per inner-loop step (256 fingerprints)
NUM_WARPS = 4
NUM_STAGES = 2
BLOCK_Q = 128       # queries per count dispatch (a TILE_Q multiple)

IMPLS = ("pallas", "pallas-interpret", "jnp")


# ---------------------------------------------------------------------------
# bit-plane packing (device, jit)

def _pack_bits(b):
    """(N, F) uint32 of 0/1 -> (N, F/32) uint32, bit f%32 of lane f//32 =
    value at f. log2 pairwise combine: never materializes a 32x intermediate."""
    c = b
    w = 1
    while w < 32:
        c = c[:, 0::2] | (c[:, 1::2] << np.uint32(w))
        w *= 2
    return c


@functools.partial(jax.jit, static_argnames=("W", "query"))
def pack_bitplanes(mat, *, W: int, query: bool):
    """(N, F) int fingerprints -> (W+1, N, F/32) uint32 bit-planes.

    Plane p < W = bit p of the value; plane W = 1 iff the slot is invalid
    (empty/out-of-range). Invalid value planes are all-0 on the stored side
    and all-1 on the query side, so invalid never matches invalid.
    """
    m = mat.astype(jnp.int32)
    valid = (m >= 0) & (m < (1 << W))
    fill = (1 << W) - 1 if query else 0
    v = jnp.where(valid, m, fill).astype(jnp.uint32)
    planes = [_pack_bits((v >> np.uint32(p)) & np.uint32(1)) for p in range(W)]
    planes.append(_pack_bits(jnp.where(valid, 0, 1).astype(jnp.uint32)))
    return jnp.stack(planes)


# ---------------------------------------------------------------------------
# the count: plain formula and Pallas kernel

def _count_jnp(qp, xp):
    """counts (Q, G) int32 of query planes qp (P, Q, L) against index planes
    xp (P, G, L), as one fused XLA reduction."""
    m = ~(qp[0][:, None, :] ^ xp[0][None, :, :])
    for p in range(1, qp.shape[0]):
        m &= ~(qp[p][:, None, :] ^ xp[p][None, :, :])
    return jnp.sum(jax.lax.population_count(m).astype(jnp.int32), axis=-1)


def _bcount_kernel(q_ref, x_ref, o_ref, *, P: int, cl: int, n_chunks: int):
    """One (TILE_Q, TILE_G) output tile. The lane axis is walked in chunks
    of ``cl`` lanes; per chunk every plane's (TILE_G, cl) index slice is
    read once and combined with the whole query tile by broadcasting, so
    the index bytes are reused TILE_Q times from registers."""
    bq, bg = o_ref.shape

    def chunk(c, acc):
        lo = pl.multiple_of(c * cl, cl)
        m = None
        for p in range(P):
            q = q_ref[p, :, pl.ds(lo, cl)]             # (bq, cl)
            x = x_ref[p, :, pl.ds(lo, cl)]             # (bg, cl)
            e = ~(q[:, None, :] ^ x[None, :, :])       # (bq, bg, cl)
            m = e if m is None else m & e
        # popcount of a signed word: Triton lowers it to the GPU's popc.
        pc = jax.lax.population_count(
            jax.lax.bitcast_convert_type(m, jnp.int32))
        return acc + jnp.sum(pc, axis=2)

    o_ref[...] = jax.lax.fori_loop(0, n_chunks, chunk,
                                   jnp.zeros((bq, bg), jnp.int32))


def _count_pallas(qp, xp, *, interpret: bool = False):
    P, Q, L = qp.shape
    G = xp.shape[1]
    bq, bg, cl = min(TILE_Q, Q), min(TILE_G, G), min(CHUNK_LANES, L)
    assert Q % bq == 0 and G % bg == 0 and L % cl == 0, (qp.shape, xp.shape)
    kern = functools.partial(_bcount_kernel, P=P, cl=cl, n_chunks=L // cl)
    # Query tiles vary fastest, so the blocks that share an index tile run
    # back to back and read it from L2.
    return pl.pallas_call(
        kern,
        grid=(Q // bq, G // bg),
        in_specs=[pl.BlockSpec((P, bq, L), lambda i, j: (0, i, 0)),
                  pl.BlockSpec((P, bg, L), lambda i, j: (0, j, 0))],
        out_specs=pl.BlockSpec((bq, bg), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((Q, G), jnp.int32),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
        name="bitplane_count",
    )(qp, xp)


def _count(qp, xp, impl: str):
    """counts (Q, G) int32 by implementation ``impl`` (one of IMPLS)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown count implementation {impl!r}")
    if impl == "jnp":
        return _count_jnp(qp, xp)
    return _count_pallas(qp, xp, interpret=impl == "pallas-interpret")


@functools.partial(jax.jit, static_argnames=("impl",))
def count_planes(qp, xp, *, impl: str):
    """Jitted bit-plane count of prepared planes (see ``_count``)."""
    return _count(qp, xp, impl)


# ---------------------------------------------------------------------------
# host-facing API

def supported(F: int, W: int | None = None) -> bool:
    """Shape gate of the bit-plane count: whole 32-fingerprint lanes."""
    return F % 32 == 0 and (W is None or 1 <= W <= 30)


def count_impl(mode: str | None = None) -> str:
    """The count implementation for ``mode`` (default: $NIQKI_TPU_COUNT).

    On a GPU backend the Pallas kernel compiles or the call fails; on the
    CPU backend the plain formula serves. The interpreter runs only when
    asked for by name (``bcount-interpret``), and asking for the GPU kernel
    (``bcount``) without a GPU raises instead of interpreting it."""
    if mode is None:
        mode = os.environ.get("NIQKI_TPU_COUNT", "auto")
    if mode == "bcount-interpret":
        return "pallas-interpret"
    if mode == "jnp":
        return "jnp"
    gpu = jax.default_backend() == "gpu"
    if mode == "bcount" and not gpu:
        raise RuntimeError(
            "NIQKI_TPU_COUNT=bcount asks for the GPU count kernel, but the "
            f"JAX backend is {jax.default_backend()!r}")
    return "pallas" if gpu else "jnp"


def pad_rows(mat16: np.ndarray, tile: int | None = None) -> np.ndarray:
    """Pad index rows to a ``tile`` (default TILE_G) multiple with the
    never-matching -2 (into a hugepage-backed destination,
    niqki_tpu/hostmem.py)."""
    tile = tile or TILE_G
    G, F = mat16.shape
    Gp = -(-G // tile) * tile
    if Gp == G:
        return mat16
    from ..hostmem import big_empty
    out = big_empty((Gp, F), mat16.dtype)
    out[:G] = mat16
    out[G:] = -2
    return out


def build_index_planes(mat: np.ndarray, W: int, row_chunk: int | None = None,
                       sanitized: bool = False):
    """(G, F) host int matrix -> (W+1, Gp, F/32) uint32 device bit-planes.

    Rows are shipped and packed in chunks so peak device memory overhead
    stays at one chunk of the unpacked form. ``sanitized=True`` promises
    every value is in [-2, 2^W) (index._stored() output); that makes an
    int16 narrowing lossless for W <= 14, halving the h2d bytes.
    Unsanitized input keeps its dtype — an out-of-range value must reach
    pack_bitplanes' range check un-aliased."""
    from ..debug import note
    note("count:planes-built")
    m = pad_rows(np.asarray(mat))
    if row_chunk is None:
        # Bound the unpacked on-device chunk (+ the pack's per-plane
        # temps) by element count, not row count.
        row_chunk = max(TILE_G, (1 << 26) // m.shape[1])
    if sanitized and W <= 14 and m.dtype != np.int16:
        from ..hostmem import big_copy
        m = big_copy(m, np.int16)
    chunks = [pack_bitplanes(jnp.asarray(m[lo:lo + row_chunk]), W=W,
                             query=False)
              for lo in range(0, m.shape[0], row_chunk)]
    out = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, axis=1)
    return jax.block_until_ready(out)


@functools.partial(jax.jit, static_argnames=("W", "impl"))
def _pack_count_call(qblk, xp, *, W: int, impl: str):
    """One fused per-block dispatch: device-side bit-plane pack of a query
    block + the count."""
    qp = pack_bitplanes(qblk, W=W, query=True)
    return _count(qp, xp, impl)


def _unsplit_wire(wirebuf, B: int):
    """Device side of _split_wire_block: (B, F) int32 fingerprints with -3
    for invalid slots. All elementwise/reshape, so XLA fuses it into the
    plane pack that follows."""
    F = wirebuf.size * 8 // (13 * B)
    lo = wirebuf[:B * F].reshape(B, F)
    nib = wirebuf[B * F:B * F + B * F // 2].reshape(B, F // 2)
    mask = wirebuf[B * F + B * F // 2:].reshape(B, F // 8)
    n = nib.astype(jnp.int32)
    exp = jnp.stack([n & 15, n >> 4], axis=-1).reshape(B, -1)
    m = mask.astype(jnp.int32)
    bits = jnp.stack([(m >> k) & 1 for k in range(8)],
                     axis=-1).reshape(B, -1)
    q12 = lo.astype(jnp.int32) | (exp << 8)
    return jnp.where(bits == 1, q12, -3)


@functools.partial(jax.jit, static_argnames=("B", "W", "impl"))
def _pack_count_call_split(wirebuf, xp, *, B: int, W: int, impl: str):
    """Split-wire variant of _pack_count_call: rebuild the W<=12-bit
    fingerprints from the 3-stream wire, then pack + count in the same
    dispatch."""
    qp = pack_bitplanes(_unsplit_wire(wirebuf, B), W=W, query=True)
    return _count(qp, xp, impl)


def _split_wire_block(blk: np.ndarray) -> np.ndarray:
    """int16 sanitized block (B, F) -> one 1-D uint8 wire buffer holding
    three contiguous streams:

    lo   B*F     mantissa bytes
    nib  B*F/2   two 4-bit exponents per byte
    mask B*F/8   validity bits, little bit-order

    1.625 bytes/slot vs int16's 2.0, in one h2d copy per block. Requires
    the sanitized contract (values in [-3, 2^W), W <= 12): the only
    negatives are the -3 sentinel, so validity is just (blk >= 0), and the
    0xFF high byte of a sentinel is masked to 4 bits before nibble
    packing."""
    B, F = blk.shape
    b = blk.view(np.uint8).reshape(B, F, 2)  # little-endian
    out = np.empty(B * F + B * F // 2 + B * F // 8, np.uint8)
    out[:B * F] = b[..., 0].ravel()
    hi = b[..., 1] & np.uint8(0xF)
    nv = out[B * F:B * F + B * F // 2].reshape(B, F // 2)
    np.bitwise_or(hi[:, 0::2], hi[:, 1::2] << np.uint8(4), out=nv)
    out[B * F + B * F // 2:] = np.packbits(blk >= 0, axis=1,
                                           bitorder="little").ravel()
    return out


def _mask_topk(vals, idx, min_score):
    """Zero out sub-threshold top-k entries on device, so consumers see
    (0, gid 0) pairs, which every one of them ignores (min_score >= 1 on
    this path)."""
    keep = vals >= min_score
    return jnp.where(keep, vals, 0), jnp.where(keep, idx, 0)


@functools.partial(jax.jit, static_argnames=("B", "W", "cap", "impl"))
def _pack_count_topk_split(wirebuf, xp, min_score, *, B: int, W: int,
                           cap: int, impl: str):
    c = _pack_count_call_split(wirebuf, xp, B=B, W=W, impl=impl)
    return _mask_topk(*jax.lax.top_k(c, cap), min_score)


@functools.partial(jax.jit, static_argnames=("W", "cap", "impl"))
def _pack_count_topk(qblk, xp, min_score, *, W: int, cap: int, impl: str):
    c = _pack_count_call(qblk, xp, W=W, impl=impl)
    return _mask_topk(*jax.lax.top_k(c, cap), min_score)


def match_counts_planes(q_np: np.ndarray, xp, G: int, W: int,
                        impl: str,
                        sanitized: bool = False,
                        topk: int | None = None,
                        min_score: int = 1):
    """counts (Q, G) int32 of host queries q_np (Q, F) against pre-packed
    device bit-planes xp (W+1, Gp, F/32), by count implementation ``impl``.

    Queries ship one BLOCK_Q block per transfer, with the next block's h2d
    overlapping the current block's count (a ship thread keeps two
    transfers in flight). Wire format (NIQKI_TPU_WIRE): the default
    ``split`` ships three streams per block — mantissa bytes,
    nibble-packed exponents, validity bitmask (1.625 B/slot) — and
    ``int16`` ships one (B, F) int16 array (2.0 B/slot).

    ``sanitized=True`` promises every value is already in [-3, 2^W)
    (index._query_side output) and skips the range pass.

    ``topk=cap`` fuses a per-row jax.lax.top_k(cap) into each dispatch and
    returns (vals, idx) (Q, cap) int32 instead of dense counts: only
    surviving hit candidates cross d2h. Rows with >= cap survivors must be
    re-fetched dense by the caller (vals[:, -1] tells)."""
    dt = np.int16 if W <= 14 else np.int32
    q = np.asarray(q_np)
    if q.dtype not in (np.int16, np.int32, np.int64):
        q = q.astype(np.int64)  # widest: no aliasing before the range pass
    if sanitized and os.environ.get("NIQKI_TPU_DEBUG"):
        # The sanitized=True contract is an unchecked caller promise: an
        # out-of-range value here would alias a valid fingerprint through
        # the int16 narrowing below. Cheap debug-mode verification.
        assert q.size == 0 or (q.min() >= -3 and q.max() < (1 << W)), \
            "sanitized=True caller broke the [-3, 2^W) contract"
    if not sanitized:
        # sanitize BEFORE any narrowing cast: an out-of-range value must
        # not alias a valid fingerprint through int16 wraparound
        q = np.where((q < 0) | (q >= (1 << W)), q.dtype.type(-3), q)
    q = np.ascontiguousarray(q, dt)
    Q, F = q.shape
    Qp = -(-Q // BLOCK_Q) * BLOCK_Q
    if Qp != Q:
        q = np.vstack([q, np.full((Qp - Q, F), -3, dt)])
    blocks = list(range(0, Qp, BLOCK_Q))

    wire = os.environ.get("NIQKI_TPU_WIRE", "split")
    use_split = wire == "split" and W <= 12 and dt == np.int16

    if use_split:
        def ship(lo_):
            return jax.device_put(_split_wire_block(q[lo_:lo_ + BLOCK_Q]))

        def dispatch(dev):
            if topk is not None:
                return _pack_count_topk_split(dev, xp, min_score,
                                              B=BLOCK_Q, W=W, cap=topk,
                                              impl=impl)
            return _pack_count_call_split(dev, xp, B=BLOCK_Q, W=W,
                                          impl=impl)
    else:
        def ship(lo_):
            return jax.device_put(q[lo_:lo_ + BLOCK_Q])

        def dispatch(dev):
            if topk is not None:
                return _pack_count_topk(dev, xp, min_score, W=W, cap=topk,
                                        impl=impl)
            return _pack_count_call(dev, xp, W=W, impl=impl)

    def finish(outs):
        if topk is not None:
            vals = jnp.concatenate([o[0] for o in outs], axis=0)
            idx = jnp.concatenate([o[1] for o in outs], axis=0)
            return vals[:Q], idx[:Q]
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return out[:Q, :G]

    if len(blocks) == 1:
        return finish([dispatch(ship(0))])
    # Pipelined: ship block i+1 (including its host-side split pack) while
    # block i's count runs.
    from concurrent.futures import ThreadPoolExecutor
    outs = []
    with ThreadPoolExecutor(1) as shipper:
        futs = [shipper.submit(ship, lo) for lo in blocks[:2]]
        for i, lo in enumerate(blocks):
            dev = futs.pop(0).result()
            if i + 2 < len(blocks):
                futs.append(shipper.submit(ship, blocks[i + 2]))
            outs.append(dispatch(dev))
    return finish(outs)


def np_pack_bitplanes(mat: np.ndarray, W: int,
                      out: np.ndarray | None = None,
                      row_chunk: int = 2048) -> np.ndarray:
    """Host (numpy) twin of pack_bitplanes(query=False) — bit-identical
    (tested), used by checkpoint v3 to persist packed planes and by the
    mesh-direct loader to assemble per-device planes without a device
    round trip. Chunked so temporaries stay ~row_chunk*F."""
    m = np.asarray(mat)
    N, F = m.shape
    L = F // 32
    assert F % 32 == 0
    if out is None:
        from ..hostmem import big_empty
        out = big_empty((W + 1, N, L), np.uint32)

    # Native AVX-512 fast path (two vptestmd per plane per 32 values);
    # bit-identical, falls through on layout/lib misfit.
    from .. import native
    if native.available() and native.pack_bitplanes(m, W, out):
        return out

    def pack_bits(b):
        c = b
        w = 1
        while w < 32:
            c = c[:, 0::2] | (c[:, 1::2] << np.uint32(w))
            w *= 2
        return c

    for lo in range(0, N, row_chunk):
        blk = m[lo:lo + row_chunk].astype(np.int32, copy=False)
        valid = (blk >= 0) & (blk < (1 << W))
        v = np.where(valid, blk, 0).astype(np.uint32)
        for p in range(W):
            out[p, lo:lo + row_chunk] = pack_bits((v >> np.uint32(p))
                                                  & np.uint32(1))
        out[W, lo:lo + row_chunk] = pack_bits((~valid).astype(np.uint32))
    return out


# ---------------------------------------------------------------------------
# all-vs-all self-join (matrix mode)

MATRIX_BLOCK = 8 * BLOCK_Q   # index rows per self-join dispatch


def _planes_as_queries(xp, lo: int, B: int):
    """Slice B stored rows out of the index planes and re-encode them as
    QUERY planes — the all-vs-all matrix needs zero query h2d because the
    queries ARE the index. Stored-invalid slots have all-0 value planes +
    sentinel 1; query-invalid needs all-1 value planes + sentinel 1, so
    the conversion is value |= sentinel. Valid slots (sentinel 0) pass
    through — the result is exactly pack_bitplanes(values, query=True) of
    the same fingerprints."""
    P = xp.shape[0]
    qs = jax.lax.dynamic_slice(
        xp, (0, lo, 0), (P, B, xp.shape[2]))
    return jnp.concatenate([qs[:P - 1] | qs[P - 1:], qs[P - 1:]], axis=0)


@functools.partial(jax.jit, static_argnames=("B", "cap", "impl"))
def _self_join_topk(xp, lo, min_score, *, B: int, cap: int, impl: str):
    """counts of index rows [lo, lo+B) against the whole index, wrapped to
    the reference's uint16 matrix counters, then top-cap compacted per row
    so only (count, gid) survivors cross d2h. Returns (vals, idx) each
    (B, cap), count-descending, with sub-min_score entries masked to
    (0, 0) on device. Wrapped counts fit uint16 exactly, so vals ship as
    uint16 (consumers compare/convert host-side)."""
    c = _count(_planes_as_queries(xp, lo, B), xp, impl)
    c = c & 0xFFFF   # reference uint16 counters (niqki_index.cpp:572)
    v, g = _mask_topk(*jax.lax.top_k(c, cap), min_score)
    return v.astype(jnp.uint16), g


def extend_planes(xp, extra: int):
    """Append ``extra`` never-matching stored-invalid rows (all-0 value
    planes + all-1 sentinel) to index planes — the symmetric sweep's
    quantized windows may read past Gp, and padding rows count 0 against
    everything (masked out by min_score >= 1 on that path)."""
    if extra <= 0:
        return xp
    P, _, L = xp.shape
    pad_v = jnp.zeros((P - 1, extra, L), jnp.uint32)
    pad_s = jnp.full((1, extra, L), 0xFFFFFFFF, jnp.uint32)
    return jnp.concatenate([xp, jnp.concatenate([pad_v, pad_s], 0)], axis=1)


@functools.partial(jax.jit, static_argnames=("B", "w", "cap", "impl"))
def _self_join_window_topk(xp, lo, min_score, *, B: int, w: int, cap: int,
                           impl: str):
    """Symmetric-sweep step: counts of index rows [lo, lo+B) against the
    UPPER-TRIANGLE column window [lo, lo+w*B) of the extended planes only
    — the strictly-lower tiles are recovered host-side by mirroring
    (counts[a, b] == counts[b, a]; equality counts are symmetric), so each
    unordered pair is computed exactly once and the per-dispatch count,
    top_k, and survivor d2h all scale with the window instead of the full
    Gp. Returns (vals, gids) (B, min(cap, w*B)) wrapped counts with GLOBAL
    gids, sub-min_score entries masked to (0, 0) on device. The
    reference's own sweep is the full G x G query_range loop
    (/root/reference/src/niqki_index.cpp:570-610)."""
    P = xp.shape[0]
    qp = _planes_as_queries(xp, lo, B)
    xwin = jax.lax.dynamic_slice(xp, (0, lo, 0), (P, w * B, xp.shape[2]))
    c = _count(qp, xwin, impl)
    c = c & 0xFFFF   # reference uint16 counters (niqki_index.cpp:572)
    vals, pos = jax.lax.top_k(c, min(cap, w * B))
    v, g = _mask_topk(vals, lo + pos, min_score)
    return v.astype(jnp.uint16), g   # see _self_join_topk: uint16 wire


@functools.partial(jax.jit, static_argnames=("B", "impl"))
def _self_join_dense(xp, lo, *, B: int, impl: str):
    """Dense variant: (B, Gp) uint16 wrapped counts (min_score == 0 rows
    print every cell, so there is nothing to compact — uint16 halves the
    d2h bytes and IS the reference's counter width)."""
    c = _count(_planes_as_queries(xp, lo, B), xp, impl)
    return (c & 0xFFFF).astype(jnp.uint16)


def match_counts_bitplane(q_sk, g_sk, W: int, impl: str) -> jnp.ndarray:
    """Convenience wrapper packing both sides; for a resident index use
    build_index_planes + match_counts_planes."""
    g = np.asarray(g_sk)
    xp = build_index_planes(g, W)
    return match_counts_planes(np.asarray(q_sk), xp, g.shape[0], W, impl)
