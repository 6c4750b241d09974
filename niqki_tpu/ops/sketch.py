"""Device sketching: vectorized k-mer hashing + per-slot min.

Data-parallel redesign of the reference's sequential rolling loop
(/root/reference/src/niqki_index.cpp:335-358): a k-mer window is just a
weighted sum of 2-bit codes, so ALL windows are computed at once as uint32
pairs (no sequential state), hashed with the u32-pair xorshift-multiply
family, fingerprinted, and min-scattered into the F sketch slots.

The sketch table uses INT32_MAX as the "empty" sentinel on device (host code
converts to the reference's -1). Densification is inherently sequential and
value-dependent, so it stays on the host (oracle.densify / native ext).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import SketchParams
from . import u32pair as u

INT32_MAX = np.int32(np.iinfo(np.int32).max)


def padded_size(n: int, minimum: int = 1 << 14) -> int:
    """Pad sequence lengths to limit jit recompiles: next power of two, with
    a floor; beyond 2^20 pad to the next multiple of 2^20 instead (within
    ~6% waste) to keep the number of distinct compiled shapes tiny."""
    n = max(n, minimum)
    if n <= 1 << 20:
        return 1 << (n - 1).bit_length()
    m = 1 << 20
    return (n + m - 1) // m * m


def _kmer_pairs(codes: jnp.ndarray, K: int, reverse: bool):
    """uint32 (hi, lo) k-mer values for all len(codes) - K window positions.

    forward:  kmer[i] = sum_j codes[i+j] << 2*(K-1-j)
    reverse:  kmer[i] = sum_j codes[i+j] << 2*j
    2-bit codes at even shifts never straddle the 32-bit boundary, so hi/lo
    split cleanly.
    """
    n = codes.shape[0] - K
    hi = jnp.zeros((n,), jnp.uint32)
    lo = jnp.zeros((n,), jnp.uint32)
    for j in range(K):
        c = jax.lax.dynamic_slice_in_dim(codes, j, n).astype(jnp.uint32)
        shift = 2 * j if reverse else 2 * (K - 1 - j)
        if shift < 32:
            lo = lo | (c << shift)
        else:
            hi = hi | (c << (shift - 32))
    return hi, lo


def _slot_fp_core(eff_fwd, eff_rc, n_kmers, *, lF, K, W, H,
                  mask_M=None, max_rem=None):
    """(slot, fp) int32 arrays for every k-mer window; padding positions get
    fp = INT32_MAX. mask_M/max_rem default to the values derived from H;
    the -G path passes the reference's stale constants explicitly
    (SketchParams.with_best_H)."""
    M = W - H
    maximal_remainder = (1 << H) - 1 if max_rem is None else max_rem
    mask_M = jnp.uint32((1 << M) - 1 if mask_M is None else mask_M)

    fwd_hi, fwd_lo = _kmer_pairs(eff_fwd, K, reverse=False)
    rc_hi, rc_lo = _kmer_pairs(eff_rc, K, reverse=True)

    # canonical k-mer = min(fwd, rc) as a 64-bit value
    swap = (rc_hi < fwd_hi) | ((rc_hi == fwd_hi) & (rc_lo < fwd_lo))
    canon_hi = jnp.where(swap, rc_hi, fwd_hi)
    canon_lo = jnp.where(swap, rc_lo, fwd_lo)

    h_hi, h_lo = u.revhash64_u32(canon_hi, canon_lo)        # fingerprint hash
    b_hi, _ = u.unrevhash64_u32(canon_hi, canon_lo)         # slot selector
    slot = (b_hi >> (32 - lF)).astype(jnp.int32)

    # HyperMinHash fingerprint: saturated (2^H-1 - clz64) exponent combined
    # with the mantissa by ADDITION (the reference does `result +=
    # remaining_nonzero << M`, src/niqki_index.cpp:285) — identical to OR for
    # normal params, but the -G stale mask_M can overlap the shifted
    # exponent, where only addition reproduces the carries.
    lz = u.clz64_u32(h_hi, h_lo)
    rem = jnp.maximum(0, maximal_remainder - lz)
    fp = ((rem << M) + (h_lo & mask_M).astype(jnp.int32)).astype(jnp.int32)
    idx = jnp.arange(fp.shape[0], dtype=jnp.int32)
    return slot, jnp.where(idx < n_kmers, fp, INT32_MAX)


def _fp_bits(W, H, mask_M, max_rem):
    """Bits needed for any fingerprint value: W normally, wider when the -G
    stale constants push (max_rem << M) + mask_M past 2^W (such values exist
    in sketches — the reference only drops them at bucket insert/query)."""
    M = W - H
    mr = (1 << H) - 1 if max_rem is None else max_rem
    mm = (1 << M) - 1 if mask_M is None else mask_M
    return max(W, ((mr << M) + mm).bit_length())


def _sketch_core(eff_fwd, eff_rc, n_kmers, *, lF, K, W, H,
                 mask_M=None, max_rem=None):
    # Per-slot min as one scatter-min into the (F,) table (atomic min on a
    # GPU). Padding positions carry fp = INT32_MAX, the empty sentinel, so
    # they never lower a slot.
    slot, fp = _slot_fp_core(eff_fwd, eff_rc, n_kmers, lF=lF, K=K, W=W, H=H,
                             mask_M=mask_M, max_rem=max_rem)
    table = jnp.full((1 << lF,), INT32_MAX, jnp.int32)
    return table.at[slot].min(fp, mode="drop")


_sketch_codes_impl = jax.jit(_sketch_core,
                             static_argnames=("lF", "K", "W", "H", "mask_M", "max_rem"))

def _unpack_codes(words, exc_idx):
    """2-bit wire format -> (eff_fwd, eff_rc) uint8 arrays: unpack forward
    codes, derive the reverse complement as 3 - code, zero the exception
    positions. words: (Pw,) uint32; exc_idx: (E,) int32 with large positive
    padding (dropped by the bounded scatter)."""
    shifts = (2 * jnp.arange(16, dtype=jnp.int32)).astype(jnp.uint32)
    codes = ((words[:, None] >> shifts[None, :]) & 3).astype(jnp.uint8)
    codes = codes.reshape(-1)
    eff_rc = (3 - codes).astype(jnp.uint8)
    eff_rc = eff_rc.at[exc_idx].set(0, mode="drop")
    return codes, eff_rc


def _sketch_packed_core(words, n_kmers, exc_idx, *, lF, K, W, H,
                        mask_M=None, max_rem=None):
    codes, eff_rc = _unpack_codes(words, exc_idx)
    return _sketch_core(codes, eff_rc, n_kmers, lF=lF, K=K, W=W, H=H, mask_M=mask_M, max_rem=max_rem)


def _batch_core(words, n_kmers, exc_idx, *, lF, K, W, H,
                mask_M=None, max_rem=None, to_i16=False):
    """Batched packed-record sketch body, shared by the single-device jitted
    impl and the mesh shard_map wrapper (per-shard execution is identical —
    sharding the batch axis is a layout choice, never a semantics choice).

    to_i16 (valid when fingerprints fit 14 bits) emits the (B, F) table as
    int16 with -1 for empty, halving the d2h bytes, fused into the same
    dispatch."""
    core = functools.partial(_sketch_packed_core, lF=lF, K=K, W=W, H=H,
                             mask_M=mask_M, max_rem=max_rem)
    out = jax.vmap(core)(words, n_kmers, exc_idx)
    return _i16_table(out) if to_i16 else out


def _i16_table(t):
    return jnp.where(t == INT32_MAX, -1, t).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("lF", "K", "W", "H", "mask_M",
                                             "max_rem", "to_i16"))
def _sketch_packed_batch_impl(words, n_kmers, exc_idx, *, lF, K, W, H,
                              mask_M=None, max_rem=None, to_i16=False):
    return _batch_core(words, n_kmers, exc_idx, lF=lF, K=K, W=W, H=H,
                       mask_M=mask_M, max_rem=max_rem, to_i16=to_i16)


@functools.lru_cache(maxsize=None)
def _mesh_batch_fn(mesh, pkey, to_i16: bool = False):
    """Jitted shard_map wrapper running _batch_core with the record-batch
    axis sharded over every mesh device (('dp','tp') flattened) — the DP
    story of the production ingest path. Cached per (mesh, params)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    lF, K, W, H, mask_M, max_rem = pkey
    core = functools.partial(_batch_core, lF=lF, K=K, W=W, H=H,
                             mask_M=mask_M, max_rem=max_rem, to_i16=to_i16)
    fn = shard_map(
        core, mesh=mesh,
        in_specs=(P(("dp", "tp"), None), P(("dp", "tp")),
                  P(("dp", "tp"), None)),
        out_specs=P(("dp", "tp"), None),
        check_vma=False,
    )
    return jax.jit(fn)


# Exception-list padding: must exceed any valid base position so the bounded
# scatter drops it (int32 max — safe for any addressable record length).
EXC_PAD = np.iinfo(np.int32).max


def pack_codes(eff_fwd: np.ndarray, eff_rc: np.ndarray, K: int):
    """Python fallback for the native packed reader: (words, n, exc_idx)."""
    n = len(eff_fwd)
    nw = (n + 15) // 16
    c = np.zeros(nw * 16, np.uint32)
    c[:n] = eff_fwd
    c = c.reshape(nw, 16)
    words = np.zeros(nw, np.uint32)
    for j in range(16):
        words |= c[:, j] << np.uint32(2 * j)
    body = slice(K - 1, n)
    exc = np.nonzero(eff_rc[body] != (3 - eff_fwd[body]))[0].astype(np.int32)
    return words, n, exc + np.int32(K - 1)


def dispatch_sketch_packed_batch(records, p: SketchParams,
                                 max_elems: int = 1 << 27,
                                 min_pad: int = 1 << 14):
    """Asynchronously dispatch a window of packed records
    (words, n_bases, exc_idx): records are grouped by padded length (one
    compiled shape per bucket), stacked into one (B, Pw) buffer, shipped
    with one transfer (2 bits/base on the wire) and sketched by one vmapped
    kernel. Returns [(record_indices, device_(B,F))]; rows beyond
    len(record_indices) are padding, records with no k-mers are skipped.

    min_pad sets the smallest shape bucket: 2^14 for whole-genome ingest
    (few compile shapes), 256 for short-read lines mode where a 150 bp
    FASTQ read must not occupy a 16 kb row (~100x padding waste)."""
    groups: dict[int, list[int]] = {}
    for i, (_, n, _e) in enumerate(records):
        if n - p.K > 0:
            groups.setdefault(padded_size(n, min_pad), []).append(i)
    out = []
    # Narrow d2h wire whenever fingerprints fit 14 bits (sentinel -> -1);
    # the host collector (_finalize_tables) widens back.
    to16 = _fp_bits(p.W, p.H, p.mask_M, p.maximal_remainder) <= 14
    from ..parallel.auto import active_mesh
    mesh = active_mesh()
    if mesh is None:
        impl = functools.partial(_sketch_packed_batch_impl, to_i16=to16)
        row_align = 2
    else:
        pkey = (p.lF, p.K, p.W, p.H, p.mask_M, p.maximal_remainder)
        mesh_fn = _mesh_batch_fn(mesh, pkey, to16)
        impl = lambda w, nk, ex, **_: mesh_fn(w, nk, ex)  # noqa: E731
        row_align = 2 * mesh.devices.size  # even rows per device shard
    for P, idxs in sorted(groups.items()):
        maxb = max(1, (max_elems // 4) // P)  # words are 4x denser
        for lo in range(0, len(idxs), maxb):
            chunk = idxs[lo:lo + maxb]
            B = len(chunk)
            # Pad the row count up to a {2^k, 3*2^(k-1)} grid point (then to
            # row_align): each distinct (Bp, Pw, E) shape is a separate jit
            # compile, so a ragged tail batch must reuse the full batch's
            # executable, not mint its own. The grid caps padded-row
            # compute waste at 33%.
            # Padding rows have n_kmers = 0 and are never collected.
            Bp = 1 << (B - 1).bit_length()
            if B <= Bp // 4 * 3:
                Bp = Bp // 4 * 3
            Bp = -(-Bp // row_align) * row_align
            Pw = P // 16
            emax = max(len(records[i][2]) for i in chunk)
            E = max(8, 1 << (max(emax, 1) - 1).bit_length())
            w = np.zeros((Bp, Pw), np.uint32)
            nk = np.zeros((Bp,), np.int32)
            ex = np.full((Bp, E), EXC_PAD, np.int32)
            for row, i in enumerate(chunk):
                words, n, exc = records[i]
                w[row, :len(words)] = words
                nk[row] = n - p.K
                ex[row, :len(exc)] = exc
            dev = impl(
                jnp.asarray(w), jnp.asarray(nk), jnp.asarray(ex),
                lF=p.lF, K=p.K, W=p.W, H=p.H,
                mask_M=p.mask_M, max_rem=p.maximal_remainder)
            out.append((chunk, dev))
    return out


def dispatch_sketch(eff_fwd: np.ndarray, eff_rc: np.ndarray,
                    p: SketchParams):
    """Asynchronously dispatch one record's sketch; returns a device array.

    No host synchronization happens here: the transfer and the kernel are
    enqueued and the caller collects results later (np.asarray). This is the
    building block of the pipelined ingest path: one sync at the end of a
    batch instead of one per record.

    Returns None for records with no k-mers (length <= K).
    """
    n = len(eff_fwd)
    n_kmers = n - p.K
    if n_kmers <= 0:
        return None
    P = padded_size(n)
    f = np.zeros(P, np.uint8)
    r = np.zeros(P, np.uint8)
    f[:n] = eff_fwd
    r[:n] = eff_rc
    return _sketch_codes_impl(
        jnp.asarray(f), jnp.asarray(r), jnp.int32(n_kmers),
        lF=p.lF, K=p.K, W=p.W, H=p.H,
                mask_M=p.mask_M, max_rem=p.maximal_remainder)


def sketch_codes(eff_fwd: np.ndarray, eff_rc: np.ndarray, p: SketchParams):
    """Sketch one record's effective code arrays on device, synchronously.

    Returns an (F,) int32 numpy array of per-slot min fingerprints with
    INT32_MAX for empty slots (pre-densification).
    """
    out = dispatch_sketch(eff_fwd, eff_rc, p)
    if out is None:
        return np.full(p.F, np.iinfo(np.int32).max, np.int32)
    return np.asarray(out)


def make_sketcher(p: SketchParams):
    """Returns sketch_fn(eff_fwd, eff_rc, n_kmers) closed over the params,
    suitable for jit composition (e.g. inside shard_map pipelines)."""
    def fn(eff_fwd, eff_rc, n_kmers):
        return _sketch_codes_impl(
            eff_fwd, eff_rc, n_kmers, lF=p.lF, K=p.K, W=p.W, H=p.H,
                mask_M=p.mask_M, max_rem=p.maximal_remainder)
    return fn
