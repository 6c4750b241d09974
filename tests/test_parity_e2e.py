"""End-to-end output parity against the reference binary's golden outputs.

Every fixture here was produced by the compiled reference run single-threaded
on the bundled E. coli genomes (see tests/fixtures/PROVENANCE.md). We compare
decompressed text byte-for-byte.
"""

import gzip
import os

import pytest

from niqki_tpu import SketchIndex, SketchParams
from niqki_tpu import engine
from niqki_tpu.io.writers import GzTextWriter


def _read_gz_text(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def ecoli_index_s10(ecoli_dir):
    idx = SketchIndex(SketchParams(lF=10))
    engine.insert_fof_whole(idx, str(ecoli_dir / "file_of_file.txt"))
    return idx


def test_matrix_s10_golden(fixtures, ecoli_dir, ecoli_index_s10, tmp_path):
    out_path = str(tmp_path / "matrix.gz")
    with GzTextWriter(out_path) as out:
        engine.query_matrix(ecoli_index_s10, out)
    assert _read_gz_text(out_path) == _read_gz_text(fixtures / "matrix_s10.gz")


def test_hits_s10_j0_golden(fixtures, ecoli_dir, ecoli_index_s10, tmp_path,
                            monkeypatch):
    out_path = str(tmp_path / "hits.gz")
    monkeypatch.chdir(ecoli_dir)  # -Q resolves fof lines from CWD
    with GzTextWriter(out_path) as out:
        engine.query_fof_whole(ecoli_index_s10, "file_of_file.txt", out)
    assert _read_gz_text(out_path) == _read_gz_text(fixtures / "hits_s10_j0.gz")


def test_hits_s10_j095_golden(fixtures, ecoli_dir, ecoli_index_s10, tmp_path,
                              monkeypatch):
    import dataclasses
    idx = SketchIndex(dataclasses.replace(ecoli_index_s10.params,
                                          min_fract=0.95))
    idx._mat = ecoli_index_s10.matrix()
    idx.names = ecoli_index_s10.names
    out_path = str(tmp_path / "hits.gz")
    monkeypatch.chdir(ecoli_dir)
    with GzTextWriter(out_path) as out:
        engine.query_fof_whole(idx, "file_of_file.txt", out)
    assert _read_gz_text(out_path) == _read_gz_text(fixtures / "hits_s10_j095.gz")


def test_dump_matches_reference(fixtures, ecoli_index_s10, tmp_path):
    out = str(tmp_path / "dump.bin")
    ecoli_index_s10.dump(out)
    assert _read_gz_text(out) == _read_gz_text(fixtures / "dump_s10.bin")


def test_load_reference_dump_and_query(fixtures, ecoli_dir, tmp_path,
                                       monkeypatch):
    idx = SketchIndex.load(str(fixtures / "dump_s10.bin"))
    assert idx.G == 9
    out_path = str(tmp_path / "hits.gz")
    monkeypatch.chdir(ecoli_dir)
    with GzTextWriter(out_path) as out:
        engine.query_fof_whole(idx, "file_of_file.txt", out)
    assert _read_gz_text(out_path) == _read_gz_text(fixtures / "hits_s10_j0.gz")


def test_matrix_s15_golden(fixtures, ecoli_dir, tmp_path):
    """The headline golden: defaults K=31 S=15 W=12 H=4 must reproduce the
    README's published distance matrix exactly."""
    idx = SketchIndex(SketchParams())
    engine.insert_fof_whole(idx, str(ecoli_dir / "file_of_file.txt"))
    out_path = str(tmp_path / "matrix.gz")
    with GzTextWriter(out_path) as out:
        engine.query_matrix(idx, out)
    assert _read_gz_text(out_path) == _read_gz_text(fixtures / "matrix_s15.gz")


def test_lines_mode_golden(fixtures, tmp_path):
    for src, fix in [("multi.fa", "lines_fa_s5.gz"), ("tiny.fq", "lines_fq_s5.gz")]:
        idx = SketchIndex(SketchParams(lF=5))
        engine.insert_file_lines(idx, str(fixtures / src))
        out_path = str(tmp_path / (src + ".out.gz"))
        with GzTextWriter(out_path) as out:
            engine.query_file_lines(idx, str(fixtures / src), out)
        assert _read_gz_text(out_path) == _read_gz_text(fixtures / fix), src


def test_multiwindow_pipeline(tmp_path):
    """Ingest of a fof much larger than the pipeline window (32 files):
    exercises the windowed submit/dispatch/collect overlap and ordering."""
    import gzip as gz
    import numpy as np
    from niqki_tpu import SketchIndex, SketchParams, engine

    rng = np.random.default_rng(0)
    names = []
    for i in range(80):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                         300 + 7 * i).tobytes().decode()
        fn = tmp_path / f"g{i:03d}.fa.gz"
        with gz.open(fn, "wt") as f:
            f.write(f">g{i}\n{seq}\n")
        names.append(fn.name)
    fof = tmp_path / "fof.txt"
    fof.write_text("".join(n + "\n" for n in names))

    p = SketchParams(lF=5, K=21)
    idx = SketchIndex(p)
    engine.insert_fof_whole(idx, str(fof))
    assert idx.G == 80
    assert idx.names == names          # fof order preserved across windows
    counts = idx.all_vs_all_counts()
    assert np.array_equal(np.diag(counts), np.full(80, p.F))
    # spot-check two files against the sequential oracle
    from niqki_tpu import oracle
    from niqki_tpu.io.fasta import read_records
    for i in (0, 79):
        want = oracle.sketch_records(
            [s for _, s in read_records(str(tmp_path / names[i]), p.K)], p)
        assert np.array_equal(idx.matrix()[i], want), i


def test_query_fof_whole_batch_invariance(fixtures, ecoli_dir,
                                          ecoli_index_s10, tmp_path,
                                          monkeypatch):
    """The query pipeline's chunk size is a pure performance knob (the
    default is bcount.BLOCK_Q): output must be byte-identical for ANY
    batch, including one smaller than the fof and one that splits it
    unevenly."""
    monkeypatch.chdir(ecoli_dir)
    outs = []
    for b in (2, 4, 96):
        out_path = str(tmp_path / f"hits{b}.gz")
        with GzTextWriter(out_path) as out:
            engine.query_fof_whole(ecoli_index_s10, "file_of_file.txt", out,
                                   batch=b)
        outs.append(_read_gz_text(out_path))
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] == _read_gz_text(fixtures / "hits_s10_j0.gz")
