"""Bit-plane count (ops/bcount) vs numpy equality counts.

On the CPU backend the Pallas kernel runs in interpret mode and the plain
jnp formula runs as XLA compiles it; tests marked ``gpu`` run the compiled
kernel and skip without a GPU (chip_smoke.py runs them on the card).
Every count is an integer and no floating-point operation is on either
path (so no TF32 either): every comparison is exact equality.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from niqki_tpu.ops import bcount


def _ref_counts(q, g):
    return (q[:, None, :] == g[None, :, :]).sum(-1, dtype=np.int32)


def _sanitized_ref(q, g, W):
    """numpy counts with the engine's sentinel rules: out-of-range query
    slots (-3) and stored slots (-2) match nothing, not even each other."""
    qs = np.where((q < 0) | (q >= 1 << W), -3, q)
    gs = np.where((g < 0) | (g >= 1 << W), -2, g)
    return _ref_counts(qs, gs)


def test_pack_bitplanes_roundtrip():
    rng = np.random.default_rng(0)
    W = 12
    m = rng.integers(0, 1 << W, size=(4, 4096), dtype=np.int32)
    planes = np.asarray(bcount.pack_bitplanes(jnp.asarray(m), W=W,
                                              query=False))
    assert planes.shape == (W + 1, 4, 128)   # (planes, rows, packed-f)
    # reconstruct values from the planes
    rec = np.zeros_like(m)
    for p in range(W):
        for f in range(m.shape[1]):
            rec[:, f] |= (((planes[p][:, f // 32] >> (f % 32)) & 1)
                          << p).astype(np.int32)
    np.testing.assert_array_equal(rec, m)
    assert not planes[W].any()  # all valid


def test_bitplane_counts_match_dense():
    rng = np.random.default_rng(1)
    W, F, G, Q = 12, 4096, 256, 5
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(0, 1 << W, size=(Q, F)).astype(np.int32)
    # force real collisions so counts are nonzero
    q[0] = g[3]
    q[1, :2048] = g[100, :2048]
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    np.testing.assert_array_equal(got, _ref_counts(q, g))
    assert got[0, 3] == F and got[1, 100] >= 2048


def test_bitplane_sentinels_never_match():
    """Stored -2 (empty/out-of-range) and query -3 rows match nothing —
    including each other (reference: neither side puts them in buckets)."""
    W, F = 12, 4096
    g = np.zeros((128, F), np.int32)
    g[1] = -2
    q = np.zeros((2, F), np.int32)
    q[1] = -3
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    assert got[0, 0] == F          # valid matches valid
    assert got[0, 1] == 0          # valid vs stored-invalid
    assert got[1, 0] == 0          # query-invalid vs valid
    assert got[1, 1] == 0          # query-invalid vs stored-invalid


def test_bitplane_wide_W():
    """W > 14 works (int32 query wire, 17 planes)."""
    rng = np.random.default_rng(2)
    W, F, G, Q = 16, 4096, 128, 3
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(0, 1 << W, size=(Q, F)).astype(np.int32)
    q[2] = g[77]
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    np.testing.assert_array_equal(got, _ref_counts(q, g))


def test_bitplane_row_and_query_padding():
    """G not a TILE_G multiple and Q not a BLOCK_Q multiple both pad away."""
    rng = np.random.default_rng(3)
    W, F, G, Q = 12, 4096, 130, 33
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(0, 1 << W, size=(Q, F)).astype(np.int32)
    q[32] = g[129]
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    assert got.shape == (Q, G)
    np.testing.assert_array_equal(got, _ref_counts(q, g))


def test_index_counts_bcount_routing(monkeypatch):
    """SketchIndex.counts through the bit-plane path (interpret mode) must
    equal the XLA path on real sketches, including sentinel slots."""
    from niqki_tpu import SketchIndex, SketchParams
    rng = np.random.default_rng(5)
    p = SketchParams(lF=12, K=21)      # F=4096
    idx = SketchIndex(p)
    for g in range(6):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        sk[rng.choice(p.F, 17, replace=False)] = -1   # empty slots survive
        idx.insert_sketch(sk, f"g{g}")
    q = idx.matrix()[:3].copy()
    monkeypatch.setenv("NIQKI_TPU_COUNT", "xla")
    want = idx.counts(q)
    monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount-interpret")
    idx._device_planes = None
    got = idx.counts(q)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("NIQKI_TPU_COUNT", "jnp")
    np.testing.assert_array_equal(idx.counts(q), want)


def test_bitplane_multi_chunk_F():
    """F large enough to span many CHUNK_LANES lane chunks accumulates."""
    rng = np.random.default_rng(4)
    W, F, G, Q = 12, 32768, 128, 2   # F/32 = 1024 lanes
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(0, 1 << W, size=(Q, F)).astype(np.int32)
    q[0] = g[5]
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    np.testing.assert_array_equal(got, _ref_counts(q, g))
    assert got[0, 5] == F


def test_pipelined_multiblock_matches_dense():
    """Q > 2*BLOCK_Q exercises the pipelined ship-thread path of
    match_counts_planes (overlapped per-block h2d + fused pack+count);
    results must be identical to the dense compare, including the padded
    tail block and sentinel queries inside the stream."""
    rng = np.random.default_rng(5)
    W, F, G = 12, 4096, 130
    Q = 2 * bcount.BLOCK_Q + 17          # 3 blocks, padded tail
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(-4, 1 << W, size=(Q, F)).astype(np.int32)
    q[97] = g[77]                        # exact row match in block 2
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    assert got.shape == (Q, G)
    np.testing.assert_array_equal(got, _ref_counts(q, g))
    assert got[97, 77] == F


@pytest.mark.parametrize("wire", ["int16", "split"])
def test_wire_formats_match_dense(wire, monkeypatch):
    """Both query wire formats (NIQKI_TPU_WIRE) produce identical counts:
    the split wire (mantissa bytes + nibble exponents + validity bitmask,
    ops/bcount._split_wire_block) is a pure layout change."""
    monkeypatch.setenv("NIQKI_TPU_WIRE", wire)
    rng = np.random.default_rng(11)
    W, F, G = 12, 4096, 130
    Q = 2 * bcount.BLOCK_Q + 5
    g = rng.integers(0, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(-4, 1 << W, size=(Q, F)).astype(np.int32)
    q[3] = g[129]
    q[bcount.BLOCK_Q + 1] = -3            # whole-row sentinel in block 2
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    np.testing.assert_array_equal(got, _ref_counts(np.where(q < 0, -9, q), g))
    assert got[3, 129] == F


def test_split_wire_block_roundtrip():
    """Host split -> device-side reconstruction is exact, sentinels included."""
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    W, F, B = 12, 4096, 3
    blk = rng.integers(0, 1 << W, size=(B, F)).astype(np.int16)
    blk[0, :7] = -3
    blk[2, ::3] = -3
    buf = bcount._split_wire_block(blk)
    assert buf.shape == (B * F + B * F // 2 + B * F // 8,)
    lo = buf[:B * F].reshape(B, F)
    nib = buf[B * F:B * F + B * F // 2].reshape(B, F // 2)
    mask = buf[B * F + B * F // 2:].reshape(B, F // 8)
    n = nib.astype(np.int32)
    exp = np.stack([n & 15, n >> 4], axis=-1).reshape(B, -1)
    m = mask.astype(np.int32)
    bits = np.stack([(m >> k) & 1 for k in range(8)], axis=-1).reshape(B, -1)
    rec = np.where(bits == 1, lo.astype(np.int32) | (exp << 8), -3)
    np.testing.assert_array_equal(rec, blk.astype(np.int32))


@pytest.mark.parametrize("W", [1, 12, 16, 30])
@pytest.mark.parametrize("G,Q", [(130, 33), (64, 1)])
def test_pallas_kernel_matches_numpy(W, G, Q):
    """The Triton-route kernel (interpreted) equals numpy at every plane
    count, with G padded to TILE_G and Q to BLOCK_Q and sentinel slots on
    both sides."""
    rng = np.random.default_rng(100 + W + G)
    F = 1024
    g = rng.integers(-2, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(-4, 1 << W, size=(Q, F)).astype(np.int32)
    q[0] = g[G - 1]
    got = np.asarray(bcount.match_counts_bitplane(q, g, W,
                                                  impl="pallas-interpret"))
    assert got.shape == (Q, G)
    np.testing.assert_array_equal(got, _sanitized_ref(q, g, W))


@pytest.mark.parametrize("F", [32, 64, 2048])
def test_jnp_count_matches_numpy(F):
    """The plain formula at F that the GPU gate takes (F % 32 == 0),
    including widths below the lane chunk and the old 4096 multiple."""
    rng = np.random.default_rng(F)
    W, G, Q = 12, 70, 9
    g = rng.integers(-2, 1 << W, size=(G, F)).astype(np.int32)
    q = rng.integers(-4, 1 << W, size=(Q, F)).astype(np.int32)
    q[3] = g[69]
    got = np.asarray(bcount.match_counts_bitplane(q, g, W, impl="jnp"))
    np.testing.assert_array_equal(got, _sanitized_ref(q, g, W))
    assert got[3, 69] == (g[69] >= 0).sum()


def test_count_planes_impls_agree():
    """count_planes: the interpreted kernel and the plain formula give the
    same counts on prepared planes whose Q and G are tile multiples."""
    rng = np.random.default_rng(9)
    W, F = 12, 512
    Q, G = bcount.TILE_Q * 2, bcount.TILE_G * 2
    g = rng.integers(-2, 1 << W, size=(G, F)).astype(np.int32)
    q = np.concatenate([g[:Q // 2], rng.integers(-3, 1 << W, (Q // 2, F))])
    xp = bcount.pack_bitplanes(jnp.asarray(g), W=W, query=False)
    qp = bcount.pack_bitplanes(jnp.asarray(q.astype(np.int32)), W=W,
                               query=True)
    a = np.asarray(bcount.count_planes(qp, xp, impl="jnp"))
    b = np.asarray(bcount.count_planes(qp, xp, impl="pallas-interpret"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _sanitized_ref(q, g, W))


def test_supported_gate():
    assert bcount.supported(32, 12) and bcount.supported(1024)
    assert not bcount.supported(16, 12)        # lF < 5: no whole lane
    assert not bcount.supported(4096, 31) and not bcount.supported(4096, 0)


def test_count_impl_choice_on_cpu(monkeypatch):
    """On the CPU backend the plain formula serves; the interpreter runs
    only by name; asking for the GPU kernel without a GPU raises."""
    monkeypatch.delenv("NIQKI_TPU_COUNT", raising=False)
    assert jax.default_backend() == "cpu"
    assert bcount.count_impl() == "jnp"
    assert bcount.count_impl("auto") == "jnp"
    assert bcount.count_impl("jnp") == "jnp"
    assert bcount.count_impl("bcount-interpret") == "pallas-interpret"
    with pytest.raises(RuntimeError, match="GPU"):
        bcount.count_impl("bcount")
    with pytest.raises(ValueError, match="unknown"):
        bcount._count(None, None, "interpret")


def test_index_counts_gpu_kernel_request_raises_on_cpu(monkeypatch):
    """SketchIndex.counts with NIQKI_TPU_COUNT=bcount on a CPU backend
    raises rather than silently interpreting the kernel."""
    from niqki_tpu import SketchIndex, SketchParams
    rng = np.random.default_rng(6)
    p = SketchParams(lF=10, K=21)
    idx = SketchIndex(p)
    for g in range(3):
        idx.insert_sketch(rng.integers(0, p.fingerprint_range, p.F)
                          .astype(np.int32), f"g{g}")
    monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
    with pytest.raises(RuntimeError, match="GPU"):
        idx.counts(idx.matrix()[:1])


def _need_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run by chip_smoke.py)")


@pytest.mark.gpu
@pytest.mark.parametrize("W,G,Q", [(12, 16384 + 37, 96), (16, 4096, 77)])
def test_gpu_kernel_matches_numpy(W, G, Q):
    """The compiled Triton kernel at real width (F=32768) equals numpy."""
    _need_gpu()
    rng = np.random.default_rng(W)
    F = 32768
    g = rng.integers(-2, 1 << W, size=(G, F)).astype(np.int32)
    q = g[rng.integers(0, G, Q)].copy()
    q[:, ::7] = rng.integers(-3, 1 << W, size=q[:, ::7].shape)
    xp = bcount.build_index_planes(g, W)
    got = np.asarray(bcount.match_counts_planes(q, xp, G, W, "pallas"))
    plain = np.asarray(bcount.match_counts_planes(q, xp, G, W, "jnp"))
    np.testing.assert_array_equal(got, plain)
    cols = rng.choice(G, 512, replace=False)   # numpy on a column sample
    np.testing.assert_array_equal(got[:, cols],
                                  _sanitized_ref(q, g[cols], W))


@pytest.mark.gpu
def test_gpu_index_counts_match_host(monkeypatch):
    """SketchIndex.counts through the compiled kernel equals the native
    host count."""
    _need_gpu()
    from niqki_tpu import SketchIndex, SketchParams, native
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(3)
    p = SketchParams()
    idx = SketchIndex(p)
    base = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
    for g in range(5000):
        sk = base.copy()
        sk[rng.random(p.F) < 0.5] = -1 if g % 2 else 7
        idx.insert_sketch(sk, f"g{g}")
    q = idx.matrix()[:40].copy()
    monkeypatch.setenv("NIQKI_TPU_COUNT", "host")
    want = idx.counts(q)
    monkeypatch.setenv("NIQKI_TPU_COUNT", "bcount")
    np.testing.assert_array_equal(idx.counts(q), want)
