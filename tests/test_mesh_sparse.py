"""Mesh sparse paths: pretty_hits_batch and the matrix
self-join under a ('dp','tp') mesh ship only per-shard top-k survivors
(global gids) across d2h — byte parity with the dense paths, including
cap-overflow re-fetch rows. No dense (Q, G) materialization on any
multi-chip hit/matrix path.
"""

import gzip

import numpy as np
import pytest

from niqki_tpu import SketchIndex, SketchParams, engine, native
from niqki_tpu.io.writers import GzTextWriter

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")


def _index_with_clusters(G, p, seed):
    """Every 3rd row is a near-copy of a shared base (a big tie cluster of
    real hits); the rest are random (near-zero counts)."""
    rng = np.random.default_rng(seed)
    idx = SketchIndex(p)
    base = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
    for i in range(G):
        if i % 3 == 0:
            sk = base.copy()
            sk[: i % 7] = (base[: i % 7] + 1) % p.fingerprint_range
        else:
            sk = rng.integers(0, p.fingerprint_range, p.F).astype(np.int32)
        idx.insert_sketch(sk, f"g{i}")
    return idx


def test_pretty_hits_batch_mesh_matches_dense(monkeypatch):
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    monkeypatch.setenv("NIQKI_TPU_HITS_CAP", "8")   # force overflow rows
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    idx = _index_with_clusters(48, p, 3)
    mat = idx.matrix()
    q = mat[:5].copy()
    q[2, ::9] = -3                                   # sentinel slots
    headers = [f"q{i}" for i in range(len(q))]
    buf = idx.pretty_hits_batch(q, headers)
    assert buf is not None
    assert idx._sharded is not None and idx._sharded._kernel == "planes"
    fmt = native.HitsFormatter(idx.names, p.F, p.min_score)
    want = fmt.format(idx.counts(q), headers)        # mesh dense counts
    assert buf == want
    # cluster queries overflowed cap=8 (dense re-fetch) while random rows
    # stayed sparse — both subpaths exercised
    assert buf.count(b":") > 8

    # no overflow regime: every row pure sparse
    monkeypatch.setenv("NIQKI_TPU_HITS_CAP", "2048")
    idx2 = _index_with_clusters(48, p, 3)
    buf2 = idx2.pretty_hits_batch(q, headers)
    assert buf2 == want


def test_pretty_hits_batch_mesh_empty_index_and_zero_cap(monkeypatch):
    """G == 0 (e.g. an insert fof whose entries were all missing) and
    NIQKI_TPU_HITS_CAP=0 must both bail to the dense path (None), not
    divide by zero in the mesh shard-cap math."""
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    p = SketchParams(lF=12, K=21, min_fract=0.05)
    empty = SketchIndex(p)
    q = np.zeros((2, p.F), np.int32)
    assert empty.pretty_hits_batch(q, ["a", "b"]) is None
    assert empty.counts(q).shape == (2, 0)

    monkeypatch.setenv("NIQKI_TPU_HITS_CAP", "0")
    idx = _index_with_clusters(24, p, 5)
    assert idx.pretty_hits_batch(q, ["a", "b"]) is None


def _matrix_bytes(idx) -> bytes:
    import tempfile, os
    fd, path = tempfile.mkstemp(suffix=".gz")
    import os as _os
    _os.close(fd)
    try:
        with GzTextWriter(path) as out:
            engine.query_matrix(idx, out)
        with gzip.open(path, "rb") as f:
            return f.read()
    finally:
        _os.unlink(path)


def test_matrix_selfjoin_mesh_matches_dense(monkeypatch):
    p = SketchParams(lF=12, K=21, min_fract=0.05)

    # dense single-device reference output
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    idx = _index_with_clusters(40, p, 7)
    want = _matrix_bytes(idx)

    # mesh self-join, sparse top-k (tiny cap forces the overflow re-fetch)
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", "4")
    idx2 = _index_with_clusters(40, p, 7)
    assert _matrix_bytes(idx2) == want

    # ...and with a roomy cap (pure sparse blocks)
    monkeypatch.setenv("NIQKI_TPU_MATRIX_CAP", "1024")
    idx3 = _index_with_clusters(40, p, 7)
    assert _matrix_bytes(idx3) == want
    assert idx3._sharded is not None and idx3._sharded._kernel == "planes"


def test_matrix_selfjoin_mesh_dense_rows_min_score0(monkeypatch):
    """min_score == 0: every cell prints, the mesh self-join ships dense
    uint16 rows per shard — still byte-identical."""
    p = SketchParams(lF=12, K=21)                    # min_fract = 0
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "dense")
    idx = _index_with_clusters(24, p, 11)
    want = _matrix_bytes(idx)
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")
    monkeypatch.setenv("NIQKI_TPU_MATRIX", "selfjoin")
    idx2 = _index_with_clusters(24, p, 11)
    assert _matrix_bytes(idx2) == want
