"""Sharded pipelines on a virtual 8-device CPU mesh (set up in conftest).

The sharded sketch (SP chunks + pmin), sharded count (DP x TP), and the full
ingest step (EP-style routed insert) must reproduce the oracle bit-for-bit —
sharding is a layout choice, never a semantics choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from niqki_tpu import oracle
from niqki_tpu.params import SketchParams
from niqki_tpu.parallel.mesh import make_mesh
from niqki_tpu.parallel.sharded import (
    chunk_codes, chunk_packed, make_ingest_step, make_ingest_step_packed,
    shard_index, sharded_count, sharded_count_planes, sharded_sketch_batch)

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh(dp=2, tp=4)


def _random_batch(p, Q, L, T, seed=0):
    rng = np.random.default_rng(seed)
    seqs = [bytes(rng.choice(list(b"ACGT"), L)) for _ in range(Q)]
    fwd = np.zeros((Q, T, 0), np.uint8)
    chunks_f, chunks_r, nvs = [], [], []
    for s in seqs:
        ef, er = oracle.encode_record(s, p.K)
        cf, nv = chunk_codes(ef, T, p.K)
        cr, _ = chunk_codes(er, T, p.K)
        chunks_f.append(cf)
        chunks_r.append(cr)
        nvs.append(nv)
    return (seqs, np.stack(chunks_f), np.stack(chunks_r),
            np.stack(nvs).astype(np.int32))


def test_chunk_codes_covers_all_kmers():
    p = SketchParams(lF=5, K=7)
    codes = np.arange(50, dtype=np.uint8) % 4
    chunks, nv = chunk_codes(codes, 4, p.K)
    assert nv.sum() == 50 - p.K
    # chunk j's k-mer w equals the global k-mer at j*C + w
    C = chunks.shape[1] - p.K
    for j in range(4):
        for w in range(nv[j]):
            np.testing.assert_array_equal(
                chunks[j, w : w + p.K], codes[j * C + w : j * C + w + p.K])


def test_sharded_sketch_matches_oracle(mesh):
    p = SketchParams(lF=6, K=21)
    Q, L, T = 4, 3000, 4
    seqs, fwd, rc, nv = _random_batch(p, Q, L, T)
    fn = sharded_sketch_batch(p, mesh)
    out = np.asarray(fn(fwd, rc, nv))
    out = np.where(out == INT32_MAX, -1, out)
    for q in range(Q):
        want = oracle.sketch_records([seqs[q]], p)
        np.testing.assert_array_equal(out[q], want, err_msg=f"q={q}")


def test_sharded_count_matches_dense(mesh):
    rng = np.random.default_rng(1)
    Q, G, F = 4, 8, 64
    q = rng.integers(0, 5, size=(Q, F)).astype(np.int32)
    g = rng.integers(0, 5, size=(G, F)).astype(np.int32)
    fn = sharded_count(mesh)
    got = np.asarray(fn(jnp.asarray(q), shard_index(g, mesh)))
    want = (q[:, None, :] == g[None, :, :]).sum(-1)
    np.testing.assert_array_equal(got, want)


def test_ingest_step_end_to_end(mesh):
    """Insert two batches with the sharded step; index and counts must match
    the oracle's sketches and dense counting exactly."""
    p = SketchParams(lF=6, K=21)
    Q, L, T, G = 2, 2000, 4, 8
    step = make_ingest_step(p, mesh)
    index = shard_index(np.full((G, p.F), -2, np.int32), mesh)
    all_seqs = []
    for b in range(2):
        seqs, fwd, rc, nv = _random_batch(p, Q, L, T, seed=10 + b)
        all_seqs.extend(seqs)
        index, counts = step(fwd, rc, nv, index,
                             jnp.int32(b * Q))
    idx_host = np.asarray(index)
    sketches = np.stack([
        np.where(s == -1, INT32_MAX, s)
        for s in (oracle.sketch_records([s], p) for s in all_seqs)])
    np.testing.assert_array_equal(idx_host[: 2 * Q], sketches)
    # untouched rows keep their initial fill
    assert (idx_host[2 * Q:] == -2).all()
    # counts of the last batch against the updated index
    want = (sketches[2:, None, :] == idx_host[None, :, :]).sum(-1)
    np.testing.assert_array_equal(np.asarray(counts), want)


@pytest.mark.parametrize("impl", ["pallas-interpret", "jnp"])
def test_sharded_count_planes_matches_dense(mesh, impl):
    """Bit-plane count under shard_map (the Pallas kernel interpreted, and
    the plain formula, on CPU) == dense."""
    from niqki_tpu.ops import bcount
    rng = np.random.default_rng(7)
    W, F = 12, 1024
    Q = 2 * bcount.BLOCK_Q                  # dp=2 -> one block per shard
    G = 4 * bcount.TILE_G                   # tp=4 -> one tile per shard
    q = rng.integers(0, 1 << W, size=(Q, F)).astype(np.int32)
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q[5] = g[G - 7]
    qp = bcount.pack_bitplanes(jnp.asarray(q), W=W, query=True)
    xp = bcount.pack_bitplanes(jnp.asarray(g), W=W, query=False)
    got = np.asarray(sharded_count_planes(mesh, impl)(qp, xp))
    want = (q[:, None, :] == g[None, :, :]).sum(-1)
    np.testing.assert_array_equal(got, want)
    assert got[5, G - 7] == F


def test_chunk_packed_matches_chunk_codes():
    """Packed-wire chunking covers the same k-mers as the uint8 chunking."""
    from niqki_tpu.ops.sketch import pack_codes, EXC_PAD, _sketch_packed_core
    from niqki_tpu.params import SketchParams
    p = SketchParams(lF=5, K=21)
    rng = np.random.default_rng(8)
    seq = bytes(rng.choice(list(b"ACGTN"), 700, p=[.24] * 4 + [.04]))
    ef, er = oracle.encode_record(seq, p.K)
    words, n, exc = pack_codes(ef, er, p.K)
    T = 4
    cw, nv, ce = chunk_packed(words, n, exc, T, p.K)
    assert nv.sum() == n - p.K
    # every chunk's device sketch must min-merge to the whole-record sketch
    tables = []
    for j in range(T):
        t = _sketch_packed_core(
            jnp.asarray(cw[j]), jnp.int32(nv[j]), jnp.asarray(ce[j]),
            lF=p.lF, K=p.K, W=p.W, H=p.H,
            mask_M=p.mask_M, max_rem=p.maximal_remainder)
        tables.append(np.asarray(t))
    merged = np.minimum.reduce(tables)
    whole = np.asarray(_sketch_packed_core(
        jnp.asarray(words), jnp.int32(n - p.K),
        jnp.asarray(exc if len(exc) else np.full(8, EXC_PAD, np.int32)),
        lF=p.lF, K=p.K, W=p.W, H=p.H,
        mask_M=p.mask_M, max_rem=p.maximal_remainder))
    np.testing.assert_array_equal(merged, whole)


def test_ingest_step_packed_end_to_end(mesh):
    """The production packed-wire ingest step == oracle sketches + counts."""
    from niqki_tpu.ops.sketch import pack_codes
    p = SketchParams(lF=6, K=21)
    Q, L, T, G = 2, 2000, 4, 8
    step = make_ingest_step_packed(p, mesh)
    index = shard_index(np.full((G, p.F), -2, np.int32), mesh)
    rng = np.random.default_rng(9)
    all_seqs = []
    for b in range(2):
        seqs = [bytes(rng.choice(list(b"ACGTN"), L, p=[.24] * 4 + [.04]))
                for _ in range(Q)]
        all_seqs.extend(seqs)
        ws, nvs, es = [], [], []
        for s in seqs:
            ef, er = oracle.encode_record(s, p.K)
            words, n, exc = pack_codes(ef, er, p.K)
            cw, nv, ce = chunk_packed(words, n, exc, T, p.K)
            ws.append(cw)
            nvs.append(nv)
            es.append(ce)
        E = max(e.shape[1] for e in es)
        from niqki_tpu.ops.sketch import EXC_PAD
        epad = np.full((Q, T, E), EXC_PAD, np.int32)
        for i, e in enumerate(es):
            epad[i, :, :e.shape[1]] = e
        index, counts = step(np.stack(ws), np.stack(nvs).astype(np.int32),
                             epad, index, jnp.int32(b * Q))
    idx_host = np.asarray(index)
    sketches = np.stack([
        np.where(s == -1, INT32_MAX, s)
        for s in (oracle.sketch_records([s], p) for s in all_seqs)])
    np.testing.assert_array_equal(idx_host[: 2 * Q], sketches)
    assert (idx_host[2 * Q:] == -2).all()
    want = (sketches[2:, None, :] == idx_host[None, :, :]).sum(-1)
    np.testing.assert_array_equal(np.asarray(counts), want)


def test_sharded_index_matches_dense():
    """ShardedIndex counts over the 8-device mesh == single-device counts,
    including non-divisible G and Q paddings."""
    import numpy as np
    from niqki_tpu import SketchIndex, SketchParams
    from niqki_tpu.parallel.serving import ShardedIndex

    p = SketchParams(lF=6, K=21)
    rng = np.random.default_rng(3)
    idx = SketchIndex(p, backend="numpy")
    for g in range(11):  # not a multiple of tp
        idx.insert_sketch(
            rng.integers(0, p.fingerprint_range, p.F).astype(np.int32),
            f"g{g}")
    q = rng.integers(0, p.fingerprint_range, (5, p.F)).astype(np.int32)
    q[0] = idx.matrix()[4]  # exact duplicate: must count F

    sh = ShardedIndex(idx)
    got = sh.counts(q)
    want = idx.counts(q)
    assert got.shape == (5, 11)
    assert np.array_equal(got, want)
    assert got[0, 4] == p.F
    top = sh.hits(q[0])[0]
    assert top == (p.F, 4)
