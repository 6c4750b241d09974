"""Randomized differential soak vs the reference binary.

Draws random parameter combinations, input shapes and CLI modes and
byte-compares decompressed outputs against the on-demand-compiled reference
(single-threaded, the deterministic-id convention every fixture uses).
Complements tests/test_reference_fuzz.py's fixed seeds: this explores the
parameter cross-product for as many trials as asked.

Usage: python tools/fuzz_soak.py [--trials 100] [--seed 0]
Exit code != 0 on the first divergence, with the repro directory kept.
"""

from __future__ import annotations

import argparse
import gzip
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
REF_SRC = pathlib.Path("/root/reference/src")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def compile_reference(tmp: pathlib.Path) -> pathlib.Path:
    exe = tmp / "niqki"
    subprocess.run(
        ["g++", "-O2", "-std=c++11", "-fopenmp", "-include", "array", "-o",
         str(exe), str(REF_SRC / "niqki.cpp"),
         str(REF_SRC / "niqki_index.cpp"), str(REF_SRC / "genome.cpp"),
         "-lz"], check=True, capture_output=True, timeout=300)
    return exe


def make_inputs(d: pathlib.Path, rng) -> tuple[pathlib.Path, pathlib.Path]:
    """Random genome fof + a lines-mode reads file in directory d."""
    alphabet = np.frombuffer(b"ACGTACGTACGTNacgt", dtype=np.uint8)
    n_files = int(rng.integers(2, 9))
    paths = []
    for i in range(n_files):
        n = int(rng.integers(150, 6000))
        seq = rng.choice(alphabet, n).tobytes().decode()
        cols = int(rng.choice([0, 0, 60, 80]))
        if cols:
            seq = "\n".join(seq[j:j + cols] for j in range(0, len(seq), cols))
        gz = bool(rng.integers(0, 2))
        name = f"g{i}.fa" + (".gz" if gz else "")
        body = f">genome_{i} desc\n{seq}\n"
        if gz:
            (d / name).write_bytes(gzip.compress(body.encode()))
        else:
            (d / name).write_text(body)
        paths.append(name)
    fof = d / "fof.txt"
    fof.write_text("".join(f"{p}\n" for p in paths))
    reads = d / ("reads.fq" if rng.integers(0, 2) else "reads.fa")
    with open(reads, "w") as f:
        for i in range(int(rng.integers(5, 40))):
            n = int(rng.integers(30, 500))
            seq = rng.choice(alphabet, n).tobytes().decode()
            if reads.suffix == ".fq":
                f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
            else:
                f.write(f">r{i}\n{seq}\n")
    return fof, reads


def draw_case(rng) -> list[str]:
    if rng.integers(0, 12) == 0:
        # Big-sketch configs (BASELINE config 3's family): S in {12,15,18}
        # with W bounded so the reference's 2^(S+W) bucket-header alloc
        # stays <= 2^26 (~1.6 GiB) per trial — the full S=18 W=12 config
        # is pinned by tests/test_s18_parity.py.
        S = int(rng.choice([12, 15, 18]))
        K = int(rng.choice([5, 11, 15, 21, 31]))
        H = int(rng.integers(2, 7))
        W = int(rng.integers(H + 1, min(26 - S, 16) + 1))
    else:
        S = int(rng.integers(4, 11))
        K = int(rng.choice([5, 11, 15, 21, 31]))
        H = int(rng.integers(2, 7))
        W = int(rng.integers(H + 1, 17))
    case = ["-S", str(S), "-K", str(K), "-W", str(W), "-H", str(H)]
    if rng.integers(0, 3) == 0:
        case += ["-G", str(int(rng.integers(500, 100000)))]
    if rng.integers(0, 3) == 0:
        case += ["-J", f"{rng.uniform(0, 0.9):.2f}"]
    return case


class ReferenceHang(Exception):
    """The reference binary exceeded the per-run timeout twice (60s, then a
    300s retry — a merely SLOW run must not bypass the differential check).
    Known reference infinite loops exist (densification when no value can
    reach an empty slot — e.g. tiny W with -G stale constants; multi-record
    whole-file mode), all documented divergences: our side terminates.
    Counted as a distinct 'hang' outcome in the soak summary, never as a
    passing trial."""


def run_ref(exe, args, cwd):
    env = {"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"}
    for timeout in (60, 300):
        try:
            subprocess.run([str(exe)] + args, cwd=cwd, check=True,
                           capture_output=True, timeout=timeout, env=env)
            return
        except subprocess.TimeoutExpired:
            log(f"reference run exceeded {timeout}s: {args}")
    raise ReferenceHang(args)


def run_ours(args):
    from niqki_tpu import cli
    rc = cli.main(args)
    assert rc == 0, args
    return rc


def one_trial(exe, base: pathlib.Path, trial: int, seed: int) -> str:
    """Returns 'pass', 'fail', or 'hang' (reference never finished — the
    differential could not be run; counted separately, not as a pass)."""
    rng = np.random.default_rng(seed * 1_000_003 + trial)
    d = base / f"t{trial}"
    d.mkdir()
    fof, reads = make_inputs(d, rng)
    case = draw_case(rng)
    mode = int(rng.integers(0, 4))
    cwd0 = os.getcwd()
    try:
        ok = _trial_body(exe, d, fof, reads, case, mode, trial)
        return "pass" if ok else "fail"
    except ReferenceHang as e:
        log(f"trial {trial}: reference binary hung twice (documented "
            f"divergence family or pathological case): {e.args[0]}")
        os.chdir(cwd0)
        shutil.rmtree(d)
        return "hang"
    finally:
        os.chdir(cwd0)


def _trial_body(exe, d, fof, reads, case, mode, trial) -> bool:
    cwd0 = os.getcwd()
    try:
        if mode == 0:      # all-vs-all matrix
            run_ref(exe, ["-M", "fof.txt", "-O", "ref.gz"] + case, d)
            run_ours(["-M", str(fof), "-O", str(d / "our.gz")] + case)
            pairs = [("ref.gz", "our.gz")]
        elif mode == 1:    # build + whole-file hits query
            run_ref(exe, ["-I", "fof.txt", "-Q", "fof.txt",
                          "-O", "ref.gz"] + case, d)
            os.chdir(d)    # -Q resolves entries from the CWD
            run_ours(["-I", str(fof), "-Q", str(fof),
                      "-O", str(d / "our.gz")] + case)
            pairs = [("ref.gz", "our.gz")]
        elif mode == 2:    # lines-mode build + query
            run_ref(exe, ["-i", reads.name, "-l", reads.name,
                          "-O", "ref.gz"] + case, d)
            run_ours(["-i", str(reads), "-l", str(reads),
                      "-O", str(d / "our.gz")] + case)
            pairs = [("ref.gz", "our.gz")]
        else:              # dump, reload, query (ours loads REF's dump too)
            run_ref(exe, ["-I", "fof.txt", "-D", "ref.dump"] + case, d)
            run_ref(exe, ["-L", "ref.dump", "-Q", "fof.txt",
                          "-O", "ref.gz"] + case, d)
            os.chdir(d)
            run_ours(["-I", str(fof), "-D", str(d / "our.dump")] + case)
            run_ours(["-L", str(d / "our.dump"), "-Q", str(fof),
                      "-O", str(d / "our.gz")] + case)
            run_ours(["-L", str(d / "ref.dump"), "-Q", str(fof),
                      "-O", str(d / "our_crossload.gz")] + case)
            pairs = [("ref.gz", "our.gz"), ("ref.gz", "our_crossload.gz")]
            if (d / "ref.dump").read_bytes() and \
                    gzip.open(d / "ref.dump").read() != \
                    gzip.open(d / "our.dump").read():
                log(f"trial {trial}: DUMP BYTES DIVERGE case={case}")
                return False
        for a, b in pairs:
            if gzip.open(d / a).read() != gzip.open(d / b).read():
                log(f"trial {trial}: OUTPUT DIVERGES mode={mode} case={case} "
                    f"({a} vs {b}) — repro kept at {d}")
                return False
    finally:
        os.chdir(cwd0)
    shutil.rmtree(d)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DxT",
                    help="run OUR side on a virtual DxT CPU mesh (forces "
                         "JAX_PLATFORMS=cpu with D*T host devices and "
                         "NIQKI_TPU_MESH) so the randomized differential "
                         "exercises the sharded product path")
    args = ap.parse_args()
    if args.mesh:
        dp, tp = map(int, args.mesh.lower().split("x"))
        # same dance as tests/conftest.py: if jax was imported before us,
        # the env var alone is too late — jax.config still wins before the
        # first device lookup
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={dp * tp}").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["NIQKI_TPU_MESH"] = args.mesh
        import jax
        jax.config.update("jax_platforms", "cpu")
        assert len(jax.devices()) == dp * tp, jax.devices()
    base = pathlib.Path(tempfile.mkdtemp(prefix="niqki_soak_"))
    exe = compile_reference(base)
    ok = hangs = 0
    for t in range(args.trials):
        outcome = one_trial(exe, base, t, args.seed)
        if outcome == "fail":
            log(f"FAILED after {ok} passing trials ({hangs} hangs); "
                f"repro under {base}")
            return 1
        ok += outcome == "pass"
        hangs += outcome == "hang"
        if (t + 1) % 10 == 0:
            log(f"{t + 1}/{args.trials} trials: {ok} OK, {hangs} hangs")
    log(f"{ok} trials byte-identical, {hangs} reference hangs "
        f"(documented-divergence skips)")
    shutil.rmtree(base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
