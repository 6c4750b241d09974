"""Device self-join all-vs-all matrix (engine._query_matrix_selfjoin):
byte parity with the legacy dense path on golden-style data, the sparse
(min_score > 0) compaction, and the top-k overflow fallback.

The self-join path is the scale route: zero query h2d (queries are the
resident index planes), device-side uint16 wrap + top-k compaction, native
row formatting. Reference behavior being reproduced:
/root/reference/src/niqki_index.cpp:570-610,747-763.
"""

import gzip
import os

import numpy as np
import pytest

from niqki_tpu import SketchIndex, SketchParams, engine, native
from niqki_tpu.io.writers import GzTextWriter

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")


def _matrix_bytes(idx, tmp_path, tag):
    p = os.path.join(str(tmp_path), f"m_{tag}.gz")
    with GzTextWriter(p) as out:
        engine.query_matrix(idx, out)
    return gzip.open(p, "rb").read()


def _rand_index(p, G, seed, empties=0):
    rng = np.random.default_rng(seed)
    idx = SketchIndex(p)
    for i in range(G):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        if empties:
            sk[rng.choice(p.F, empties, replace=False)] = -1
        idx.insert_sketch(sk, f"g{i}")
    return idx


def test_selfjoin_matches_dense_min_score_zero(tmp_path, monkeypatch):
    """min_score == 0: every cell prints; dense-d2h subpath."""
    p = SketchParams(lF=12, K=21)               # F=4096, min_score=0
    idx = _rand_index(p, 7, 31, empties=9)
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    want = _matrix_bytes(idx, tmp_path, "dense")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    got = _matrix_bytes(idx, tmp_path, "selfjoin")
    assert got == want


def test_selfjoin_matches_dense_sparse_path(tmp_path, monkeypatch):
    """min_score > 0: top-k compacted subpath, with real shared rows."""
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    idx = _rand_index(p, 6, 32)
    # make g5 share half its slots with g0 so off-diagonal survivors exist
    idx._rows[5][: p.F // 2] = idx._rows[0][: p.F // 2]
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    want = _matrix_bytes(idx, tmp_path, "dense")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    got = _matrix_bytes(idx, tmp_path, "selfjoin")
    assert got == want
    assert b"0.5" in want or b"0.49" in want  # the shared half showed up


def test_selfjoin_topk_overflow_falls_back_dense(tmp_path, monkeypatch):
    """More survivors than the top-k cap: the block re-fetches dense and
    stays byte-identical."""
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    idx = _rand_index(p, 6, 33)
    for g in range(1, 6):                       # everyone matches g0
        idx._rows[g][:] = idx._rows[0]
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    want = _matrix_bytes(idx, tmp_path, "dense")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", "2")
    got = _matrix_bytes(idx, tmp_path, "selfjoin")
    assert got == want


def test_sym_sweep_multiblock_mirrors(tmp_path, monkeypatch):
    """The symmetric triangular sweep (engine._query_matrix_selfjoin_sym):
    multi-block index with cross-block survivors, so lower-triangle cells
    come from HOST-side mirrors of upper-window tiles; quantized window
    widths (QB=2) exercise the padded-column path. Byte parity vs the
    legacy dense loop."""
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    rng = np.random.default_rng(44)
    idx = SketchIndex(p)
    anc = rng.integers(0, p.fingerprint_range, (3, p.F)).astype(np.int32)
    for i in range(300):
        sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        m = rng.random(p.F) < 0.4   # clusters of 100 share 40% of slots
        sk[m] = anc[i // 100][m]
        if i % 7 == 0:
            sk[rng.choice(p.F, 13, replace=False)] = -1
        idx.insert_sketch(sk, f"g{i}")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    want = _matrix_bytes(idx, tmp_path, "symd")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_BLOCK", "128")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_QB", "2")
    got = _matrix_bytes(idx, tmp_path, "syms")
    assert got == want
    # cluster size (100) > cap (16): every cluster row overflows its
    # shipped top-k — the per-BLOCK_Q dense re-fetch must also rebuild
    # those rows' mirror contributions (the r4 cliff: cluster > cap)
    monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", "16")
    got2 = _matrix_bytes(idx, tmp_path, "symo")
    assert got2 == want
    # legacy full sweep with the same overflow: per-sub-block re-fetch
    monkeypatch.setenv("NIQKI_TPU_MATRIX_SYM", "off")
    got3 = _matrix_bytes(idx, tmp_path, "symL")
    assert got3 == want


def test_selfjoin_golden_fixture(tmp_path, monkeypatch, ecoli_dir):
    """The ecoli golden matrices reproduce byte-identically through the
    self-join path (min_score == 0, names with dots/slashes, G=9): S=15
    (the headline configuration, F=32768) and S=10 (F=1024), which the
    bit-plane count's F % 32 gate now takes as well."""
    fof = str(ecoli_dir / "file_of_file.txt")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    idx10 = SketchIndex(SketchParams(lF=10))
    engine.insert_fof_whole(idx10, fof)
    got10 = _matrix_bytes(idx10, tmp_path, "s10")
    assert got10 == gzip.open("tests/fixtures/matrix_s10.gz", "rb").read()

    idx = SketchIndex(SketchParams())
    engine.insert_fof_whole(idx, fof)
    got = _matrix_bytes(idx, tmp_path, "golden")
    want = gzip.open("tests/fixtures/matrix_s15.gz", "rb").read()
    assert got == want
