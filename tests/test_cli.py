"""CLI driver tests: flag plumbing, dispatch order, parity through main().

The reference CLI quirks being checked are documented in cli.py and
SURVEY.md §8 (fof path resolution, -G auto-tune print, dump/load flow).
"""

import gzip

import pytest

from niqki_tpu import cli

import os

pytestmark = pytest.mark.skipif(
    not os.path.exists("/root/reference/resources"),
    reason="reference resources not mounted")

FOF = "/root/reference/resources/file_of_file.txt"
FIXDIR = __file__.rsplit("/", 1)[0] + "/fixtures"


def test_logo_only(capsys):
    assert cli.main(["--logo"]) == 0
    out = capsys.readouterr().out
    assert "k-mer fingerprint indexing" in out


def test_autotune_h_prints_choice(capsys, tmp_path):
    # SURVEY.md §2 C15: G=5e6, S=10 -> H=4 (verified against the reference).
    rc = cli.main(["-S", "10", "-G", "5000000",
                   "-O", str(tmp_path / "o.gz")])
    assert rc == 0
    assert "I chosed H=4" in capsys.readouterr().out


def test_matrix_via_cli_matches_golden(tmp_path, capsys):
    out = tmp_path / "m.gz"
    rc = cli.main(["-M", FOF, "-S", "10", "-O", str(out)])
    assert rc == 0
    got = gzip.open(out).read()
    want = gzip.open(FIXDIR + "/matrix_s10.gz").read()
    assert got == want


def test_index_dump_load_query_roundtrip(tmp_path, monkeypatch, capsys):
    dump = tmp_path / "idx.bin"
    rc = cli.main(["-I", FOF, "-S", "10", "-D", str(dump),
                   "-O", str(tmp_path / "none.gz")])
    assert rc == 0
    out = tmp_path / "hits.gz"
    # -Q resolves fof entries from the CWD (reference parity), so run from
    # the resources directory like the reference README workflow does.
    monkeypatch.chdir("/root/reference/resources")
    rc = cli.main(["-L", str(dump), "-Q", FOF, "-O", str(out)])
    assert rc == 0
    got = gzip.open(out).read()
    want = gzip.open(FIXDIR + "/hits_s10_j0.gz").read()
    assert got == want


def test_sharded_checkpoint_roundtrip(tmp_path, monkeypatch, capsys):
    ckpt = tmp_path / "ckpt"
    rc = cli.main(["-I", FOF, "-S", "10", "--save-sharded", str(ckpt),
                   "--shards", "3", "-O", str(tmp_path / "n1.gz")])
    assert rc == 0
    out = tmp_path / "hits.gz"
    # (-M on a loaded index re-inserts its fof, reference parity — so the
    # pure-roundtrip check queries instead.)
    monkeypatch.chdir("/root/reference/resources")
    rc = cli.main(["--load-sharded", str(ckpt), "-Q", FOF, "-O", str(out)])
    assert rc == 0
    got = gzip.open(out).read()
    want = gzip.open(FIXDIR + "/hits_s10_j0.gz").read()
    assert got == want


def test_query_fof_resolves_from_cwd(tmp_path, monkeypatch, capsys):
    # -Q fofs resolve entries from the CWD (not the fof's directory).
    fof = tmp_path / "q.txt"
    fof.write_text("ecoli01p.fa.gz\n")
    monkeypatch.chdir("/root/reference/resources")
    out = tmp_path / "h.gz"
    rc = cli.main(["-I", FOF, "-S", "10", "-Q", str(fof), "-O", str(out)])
    assert rc == 0
    lines = gzip.open(out).read().decode().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ecoli01p.fa.gz ")


def test_autotune_matrix_golden(tmp_path, monkeypatch, capsys):
    """-G quirk parity: select_best_H updates only H and the M shift; the
    stale mask_M/maximal_remainder must flow into every fingerprint
    (fixture: reference binary, -M -S 10 -G 1e8 -> H=5)."""
    out = tmp_path / "m.gz"
    rc = cli.main(["-M", FOF, "-S", "10", "-G", "100000000",
                   "-O", str(out)])
    assert rc == 0
    assert "I chosed H=5" in capsys.readouterr().out
    assert gzip.open(out).read() == \
        gzip.open(FIXDIR + "/matrix_s10_g1e8.gz").read()


def test_load_then_matrix_reindexes_fof(tmp_path, capsys):
    """-L + -M parity: the reference inserts the matrix fof into the loaded
    index (its condition checks only -I/-i), doubling the genome set."""
    dump = tmp_path / "d.bin"
    rc = cli.main(["-I", FOF, "-S", "10", "-D", str(dump),
                   "-O", str(tmp_path / "n.gz")])
    assert rc == 0
    out = tmp_path / "m.gz"
    rc = cli.main(["-L", str(dump), "-M", FOF, "-O", str(out)])
    assert rc == 0
    assert gzip.open(out).read() == \
        gzip.open(FIXDIR + "/matrix_s10_loadM.gz").read()


def test_load_ignores_minjac(tmp_path, monkeypatch, capsys):
    """-L parity: min_score comes from the dump; -J on the command line is
    ignored (fixture dump was built with -J 0.9)."""
    monkeypatch.chdir("/root/reference/resources")
    out = tmp_path / "h.gz"
    rc = cli.main(["-L", FIXDIR + "/dump_s10_j09.bin", "-Q", FOF,
                   "-J", "0", "-O", str(out)])
    assert rc == 0
    assert gzip.open(out).read() == \
        gzip.open(FIXDIR + "/hits_s10_loadJ09.gz").read()


def test_matrix_s16_uint16_wrap(tmp_path, capsys):
    """lF >= 16 parity: the reference's matrix counters are uint16, so a
    genome's self-count of F=65536 wraps to 0 (fixture from the reference
    binary at -S 16 -K 21 on the tiny genomes)."""
    out = tmp_path / "m.gz"
    rc = cli.main(["-M", FIXDIR + "/fof_tiny.txt", "-S", "16", "-K", "21",
                   "-O", str(out)])
    assert rc == 0
    got = gzip.open(out).read()
    assert b"\t0\t" in got or got.split(b"\n")[1].split(b"\t")[1] == b"0"
    assert got == gzip.open(FIXDIR + "/matrix_s16_tiny.gz").read()


def test_usage_on_help_and_bare(capsys):
    """-h / bare invocation print the reference usage[] text (to stderr,
    like printUsage(clog)) and exit 0 (src/niqki.cpp:252-255)."""
    assert cli.main([]) == 0
    err = capsys.readouterr().err
    assert "***Input***" in err and "--querylines, -q" in err
    with pytest.raises(SystemExit) as e:
        cli.main(["-h"])
    assert e.value.code == 0
    assert "***Advanced parameters***" in capsys.readouterr().err


def test_unknown_argument_bad_usage(capsys):
    """Non-option arguments: per-arg complaints then Bad usage!!! and
    EXIT_FAILURE (src/niqki.cpp:275-283)."""
    assert cli.main(["stray.fa"]) == 1
    out = capsys.readouterr().out
    assert "Non-option argument #0 is stray.fa" in out
    assert "Ignoring unknown argument 'stray.fa'" in out
    assert "Bad usage!!!" in out


def test_missing_index_fof_message(tmp_path, capsys):
    """-I with a missing fof: main's message, then the insert driver's
    (basename) message, then exit(0) (src/niqki.cpp:317-319,
    niqki_index.cpp:464-467)."""
    rc = cli.main(["-I", str(tmp_path / "nope" / "missing.txt"),
                   "-O", str(tmp_path / "o.gz")])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("Unable to open the file") == 2
    assert f"'{tmp_path}/nope/missing.txt'" in out
    assert "'missing.txt'" in out


def test_missing_query_fof_message(tmp_path, capsys):
    """-Q with a missing fof: the message, then nonzero exit (the reference
    crashes with an uncaught zstr exception there)."""
    rc = cli.main(["-Q", str(tmp_path / "missing.txt"),
                   "-O", str(tmp_path / "o.gz")])
    assert rc == 1
    assert "Unable to open the file" in capsys.readouterr().out


def test_missing_querylines_closes_output(tmp_path, capsys):
    """Early error exits must close -O deterministically: a header-only
    gzip with no trailer would crash downstream readers."""
    import gzip as _gzip
    o = tmp_path / "o.gz"
    rc = cli.main(["-l", str(tmp_path / "missing.fq"), "-O", str(o)])
    assert rc == 1
    assert _gzip.open(str(o), "rb").read() == b""  # valid, empty
    capsys.readouterr()


def test_missing_load_dump_message(tmp_path, capsys):
    rc = cli.main(["-L", str(tmp_path / "missing.bin"),
                   "-O", str(tmp_path / "o.gz")])
    assert rc == 1
    assert "Unable to open the file" in capsys.readouterr().out


def test_missing_matrix_fof_message(tmp_path, capsys):
    rc = cli.main(["-M", str(tmp_path / "missing.txt"),
                   "-O", str(tmp_path / "o.gz")])
    assert rc == 0
    assert capsys.readouterr().out.count("Unable to open the file") == 2


def test_query_fof_matrix_library(tmp_path, monkeypatch):
    """query_fof_matrix resolves entries from the CWD with no length filter
    (reference query_file_of_file_whole_matrix semantics)."""
    import numpy as np
    from niqki_tpu import SketchIndex, SketchParams, engine
    from niqki_tpu.io.writers import GzTextWriter
    p = SketchParams(lF=5, K=21)
    idx = SketchIndex(p, backend="numpy")
    engine.insert_fof_whole(idx, FIXDIR + "/fof_tiny.txt")
    monkeypatch.chdir(FIXDIR)
    out_fof = tmp_path / "m1.gz"
    with GzTextWriter(str(out_fof)) as out:
        engine.query_fof_matrix(idx, FIXDIR + "/fof_tiny.txt", out)
    lines = gzip.open(out_fof).read().decode().splitlines()
    assert lines[0].startswith("##Names\t")
    assert len(lines) == 1 + idx.G
    # single-file variant: one row, no header
    out_one = tmp_path / "m2.gz"
    with GzTextWriter(str(out_one)) as out:
        engine.query_file_matrix(idx, "tiny1.fa", out)
    rows = gzip.open(out_one).read().decode().splitlines()
    assert len(rows) == 1 and rows[0].startswith("tiny1.fa\t")
    # the self-row in both outputs carries the full self-similarity 1
    assert "\t1\t" in rows[0]


def test_host_routed_cli_never_inits_jax_backend(tmp_path):
    """With the host sketch route forced and a small index, a full
    build+query CLI run must never initialize a jax backend (the lazy-init
    contract). jax may be IMPORTED; what must not happen is backend
    creation."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from niqki_tpu import cli\n"
        "rc = cli.main(['-I', 'FOF', '-Q', 'FOF', '-O', 'OUT', '-S', '6'])\n"
        "assert rc == 0\n"
        "if 'jax' in sys.modules:\n"
        "    import jax._src.xla_bridge as xb\n"
        "    assert not xb.backends_are_initialized(), \\\n"
        "        'host-routed run initialized a jax backend'\n"
    )
    fof = tmp_path / "fof.txt"
    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + "ACGTTGCA" * 40 + "\n")
    fof.write_text("g.fa\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, NIQKI_TPU_SKETCH="host", NIQKI_TPU_MESH="off",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    code = code.replace("FOF", str(fof)).replace("OUT", str(tmp_path / "o.gz"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
