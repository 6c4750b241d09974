"""Bounded-memory streaming: lines-mode ingest/query and dump load must not
materialize whole files, and short reads must use small shape buckets."""

import gzip
import os
import resource

import numpy as np
import pytest

from niqki_tpu import SketchIndex, SketchParams
from niqki_tpu.ops.sketch import padded_size


def _write_reads(path, n_reads, read_len=150, seed=0):
    rng = np.random.default_rng(seed)
    with gzip.open(path, "wt") as f:
        for i in range(n_reads):
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                             read_len).tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\nIIII\n")


def test_short_read_padding_buckets():
    """150 bp reads pad to 256-base rows in lines mode, not 2^14."""
    assert padded_size(150, 256) == 256
    assert padded_size(257, 256) == 512
    assert padded_size(150) == 1 << 14  # whole-genome floor unchanged


def test_lines_chunked_equals_unchunked(tmp_path):
    fq = str(tmp_path / "reads.fq.gz")
    _write_reads(fq, 300, read_len=120, seed=1)
    p = SketchParams(lF=5, K=21)
    a = SketchIndex(p)
    a.insert_file_lines(fq, chunk_records=37)   # many partial chunks
    b = SketchIndex(p)
    b.insert_file_lines(fq, chunk_records=1 << 14)
    assert a.names == b.names and a.G == 300
    np.testing.assert_array_equal(a.matrix(), b.matrix())


def test_lines_streaming_is_lazy(tmp_path, monkeypatch):
    """insert_file_lines must pull records through the iterator chunk by
    chunk, never materializing the file (generator consumption check)."""
    fq = str(tmp_path / "reads.fq.gz")
    _write_reads(fq, 100, read_len=100, seed=2)
    p = SketchParams(lF=5, K=21)
    idx = SketchIndex(p)
    state = {"out": 0, "max_ahead": 0}
    real_iter = idx._iter_packed_with_headers(fq)

    def tracking():
        for rec in real_iter:
            state["out"] += 1
            state["max_ahead"] = max(state["max_ahead"],
                                     state["out"] - idx.G)
            yield rec
    for part, sks in idx._sketch_stream(tracking(), chunk_records=10):
        for r, sk in zip(part, sks):
            idx.insert_sketch(sk, r[0])
    assert idx.G == 100
    # at most two chunks (read-ahead) of records ever pulled beyond inserts
    assert state["max_ahead"] <= 21


def test_lines_ingest_memory_bounded(tmp_path):
    """RSS growth during a 60k-read lines ingest stays far below the
    unpacked whole-file materialization (packed records + per-record numpy
    overhead was ~1 KB/record before streaming)."""
    fq = str(tmp_path / "big.fq.gz")
    _write_reads(fq, 60_000, read_len=150, seed=3)
    p = SketchParams(lF=5, K=21)
    idx = SketchIndex(p)
    idx.insert_file_lines(fq, chunk_records=2048)  # warm compiles + pools
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    idx2 = SketchIndex(p)
    idx2.insert_file_lines(fq, chunk_records=2048)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert idx2.G == 60_000
    # ru_maxrss is KiB on Linux; allow 150 MiB of jitter (sketch rows for
    # 60k genomes at F=32 are ~8 MB; whole-file packed records would be
    # ~60 MB+ and unpacked uint8 codes ~1 GB).
    assert rss1 - rss0 < 150 * 1024, (rss0, rss1)


def test_load_dump_streaming_matches_fixture(fixtures):
    """The streaming native load path reproduces the whole-buffer parse."""
    from niqki_tpu import dumpfmt, native
    if not native.available():
        pytest.skip("native library required")
    path = str(fixtures / "dump_s10.bin")
    hdr_a, sk_a, names_a = dumpfmt.load_dump(path)
    hdr_b, sk_b, names_b = dumpfmt.load_dump(path, chunk_words=97)  # tiny
    assert names_a == names_b
    np.testing.assert_array_equal(sk_a, sk_b)
    assert (hdr_a.lF, hdr_a.min_score) == (hdr_b.lF, hdr_b.min_score)


def test_host_read_sketch_routing_matches_device(tmp_path, monkeypatch):
    """Short records route to the native host sketcher; sketches must be
    bit-identical with the device path (NIQKI_TPU_HOST_READS=0)."""
    from niqki_tpu import native
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    path = tmp_path / "reads.fq"
    with open(path, "w") as f:
        alpha = np.frombuffer(b"ACGTN", np.uint8)
        for i in range(60):
            n = int(rng.integers(60, 500))
            seq = rng.choice(alpha, n, p=[.24] * 4 + [.04]).tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
        # one long record to exercise the device branch of the same stream
        seq = rng.choice(alpha, 6000, p=[.24] * 4 + [.04]).tobytes().decode()
        f.write(f"@long\n{seq}\n+\n{'I' * 6000}\n")
    idx = SketchIndex(SketchParams(lF=8))
    monkeypatch.setenv("NIQKI_TPU_HOST_READS", "0")
    dev = [[np.asarray(s).copy() for s in sks] for _, sks in
           idx._sketch_stream(idx._iter_packed_with_headers(str(path)), 16)]
    monkeypatch.setenv("NIQKI_TPU_HOST_READS", "4096")
    host = [sks for _, sks in
            idx._sketch_stream(idx._iter_packed_with_headers(str(path)), 16)]
    assert len(dev) == len(host) and sum(map(len, dev)) == 61
    for da, ha in zip(dev, host):
        for x, y in zip(da, ha):
            assert (np.asarray(x) == np.asarray(y)).all()


def test_hits_from_counts_batch_matches_per_row():
    from niqki_tpu.index import hits_from_counts, hits_from_counts_batch
    rng = np.random.default_rng(5)
    for G, ms in ((9, 51), (9, 0), (300, 1), (1, 1), (7, 2)):
        c = rng.integers(0, 60, (40, G)).astype(np.int32)
        c[3] = 0                       # all-below-threshold row
        c[5] = 59                      # all-tied row (gid desc ordering)
        batch = hits_from_counts_batch(c, ms)
        for b in range(40):
            assert batch[b] == hits_from_counts(c[b], ms), (G, ms, b)


def test_polyN_read_terminates():
    """A poly-N (or poly-A) record sketches to the single fingerprint 0,
    whose densify probe is pinned to slot 0 (revhash64(0) == 0) — the
    reference binary infinitely loops there; we terminate with the slot
    left sparse (documented divergence). All three densify impls agree."""
    import jax.numpy as jnp
    from niqki_tpu import native, oracle
    from niqki_tpu.ops.densify import densify_device
    INT32_MAX = np.iinfo(np.int32).max
    p = SketchParams(lF=6)
    sk = np.full(p.F, -1, np.int32)
    sk[0] = 0
    a = sk.copy()
    oracle.densify(a, p)
    assert (a != -1).sum() == 1
    if native.available():
        b = sk.copy()
        native.densify(b)
        assert np.array_equal(a, b)
    t = np.where(sk == -1, INT32_MAX, sk).astype(np.int32)
    d = np.asarray(densify_device(jnp.asarray(t), lF=p.lF))
    assert np.array_equal(a, np.where(d == INT32_MAX, -1, d))
    # end to end: a poly-N read in lines mode must not hang the stream
    idx = SketchIndex(p)
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "r.fq")
        with open(fq, "w") as f:
            f.write(f"@polyN\n{'N' * 200}\n+\n{'I' * 200}\n")
        chunks = list(idx._sketch_stream(
            idx._iter_packed_with_headers(fq), 8))
        assert len(chunks) == 1
        (_, sks), = chunks
        assert (np.asarray(sks[0]) != -1).sum() == 1
