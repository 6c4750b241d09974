"""Production multi-device path: the REAL engine/CLI surface on a mesh.

`-M`/`-Q`/`-I` through the CLI on the 8-virtual-
device CPU mesh must produce byte-identical goldens — the sharded sketch
dispatch (record batch over ('dp','tp')), the tp-row-sharded ShardedIndex
count path, and the packed-wire ingest step are the product, not a demo.
"""

import gzip
import os

import numpy as np
import pytest

from niqki_tpu import cli

pytestmark = pytest.mark.skipif(
    not os.path.exists("/root/reference/resources"),
    reason="reference resources not mounted")

FOF = "/root/reference/resources/file_of_file.txt"
FIXDIR = __file__.rsplit("/", 1)[0] + "/fixtures"


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    monkeypatch.setenv("NIQKI_TPU_MESH", "2x4")


def test_cli_tiny_matrix_golden_on_mesh(tmp_path):
    """-M through the CLI on the 2x4 mesh: byte-identical golden (including
    the uint16-wrap quirk at S=16)."""
    out = tmp_path / "m.gz"
    rc = cli.main(["-M", FIXDIR + "/fof_tiny.txt", "-S", "16", "-K", "21",
                   "-O", str(out)])
    assert rc == 0
    assert gzip.open(out).read() == \
        gzip.open(FIXDIR + "/matrix_s16_tiny.gz").read()


def test_cli_matrix_s10_golden_on_mesh(tmp_path):
    """The full ecoli S=10 golden through the CLI on the mesh (the headline
    'done' criterion): sharded sketch + sharded count, byte parity."""
    out = tmp_path / "m.gz"
    rc = cli.main(["-M", FOF, "-S", "10", "-O", str(out), "--mesh", "2x4"])
    assert rc == 0
    assert gzip.open(out).read() == \
        gzip.open(FIXDIR + "/matrix_s10.gz").read()


def test_cli_query_hits_golden_on_mesh(tmp_path, monkeypatch):
    """-I + -Q on the mesh reproduces the hits golden byte-for-byte."""
    out = tmp_path / "hits.gz"
    monkeypatch.chdir("/root/reference/resources")
    rc = cli.main(["-I", FOF, "-S", "10", "-Q", FOF, "-O", str(out)])
    assert rc == 0
    assert gzip.open(out).read() == \
        gzip.open(FIXDIR + "/hits_s10_j0.gz").read()


def test_sketch_files_mesh_matches_single_device(monkeypatch):
    """sketch_files with the mesh == without, record for record."""
    from niqki_tpu import SketchIndex, SketchParams
    p = SketchParams(lF=6, K=21)
    paths = [f"{FIXDIR}/tiny{i}.fa" for i in (1, 2, 3)]
    on = SketchIndex(p).sketch_files(paths)
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    off = SketchIndex(p).sketch_files(paths)
    for a, b, path in zip(on, off, paths):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_mesh_flip_invalidates_sharded_cache(monkeypatch):
    """Flipping NIQKI_TPU_MESH between counts calls in one process must
    rebuild the sharded serving object on the new layout and keep results
    identical — sharding is a layout choice."""
    from niqki_tpu import SketchIndex, SketchParams
    rng = np.random.default_rng(0)
    p = SketchParams(lF=6)
    idx = SketchIndex(p)
    for g in range(16):
        idx.insert_sketch(
            rng.integers(0, p.fingerprint_range, p.F).astype(np.int32),
            f"g{g}")
    q = rng.integers(0, p.fingerprint_range, (4, p.F)).astype(np.int32)
    c1 = idx.counts(q)                        # autouse env: 2x4
    sharded1 = idx._sharded
    assert sharded1 is not None
    assert dict(sharded1.mesh.shape) == {"dp": 2, "tp": 4}
    monkeypatch.setenv("NIQKI_TPU_MESH", "4x2")
    c2 = idx.counts(q)
    assert idx._sharded is not sharded1, "stale mesh layout reused"
    assert dict(idx._sharded.mesh.shape) == {"dp": 4, "tp": 2}
    np.testing.assert_array_equal(c1, c2)
    monkeypatch.setenv("NIQKI_TPU_MESH", "off")
    np.testing.assert_array_equal(c1, idx.counts(q))
