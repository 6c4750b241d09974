"""Short-read (lines-mode) benchmark: 100k x 150 bp FASTQ through -l/-i,
parity-gated against the reference binary on the SAME input.

Workloads (S=10 defaults otherwise):
  * query:  -I <9 ecoli genomes>  -l reads.fq   (sketch every read, count
            against the genome index, pretty hits per read)
  * index:  -i reads.fq                          (every read becomes an entry)

The reference binary is compiled on demand from /root/reference and runs
single-threaded (the BASELINE.md anchor convention). Outputs must match
byte-for-byte before any timing is reported.

Each metric prints one JSON line. Usage: python bench_reads.py [--reads N]
"""

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ECOLI_FOF = "/root/reference/resources/file_of_file.txt"
REF_SRC = "/root/reference/src"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def reads_file(n: int, length: int = 150) -> str:
    """Cached FASTQ of n reads sampled from ecoli01p (so counts are
    non-trivial), plain text (the reference reads .fq by substring)."""
    cache = os.path.expanduser("~/.cache/niqki_tpu")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"reads_{n}x{length}.fq")
    if os.path.exists(path):
        return path
    log(f"generating {path}...")
    with gzip.open("/root/reference/resources/ecoli01p.fa.gz", "rt") as f:
        seq = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    rng = np.random.default_rng(7)
    starts = rng.integers(0, len(seq) - length, n)
    qual = "I" * length
    with open(path + ".tmp", "w") as f:
        for i, s in enumerate(starts):
            f.write(f"@r{i}\n{seq[s:s + length]}\n+\n{qual}\n")
    os.rename(path + ".tmp", path)
    return path


def compile_reference(tmp: str) -> str | None:
    exe = os.path.join(tmp, "niqki")
    cmd = ["g++", "-O3", "-std=c++11", "-funroll-loops", "-fopenmp",
           "-include", "array", "-o", exe,
           f"{REF_SRC}/niqki.cpp", f"{REF_SRC}/niqki_index.cpp",
           f"{REF_SRC}/genome.cpp", "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception as e:
        log(f"cannot compile reference: {e}")
        return None
    return exe


def run_reference(exe: str, args: list[str], cwd: str) -> float:
    t0 = time.time()
    subprocess.run([exe] + args, cwd=cwd, check=True, capture_output=True,
                   timeout=3600,
                   env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"})
    return time.time() - t0


def run_ours(args: list[str]) -> float:
    from niqki_tpu import cli
    t0 = time.time()
    rc = cli.main(args)
    assert rc == 0
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--skip-reference", action="store_true",
                    help="only run (and warm) our engine")
    args = ap.parse_args()
    fq = reads_file(args.reads)
    base = ["-S", "10"]

    with tempfile.TemporaryDirectory() as td:
        exe = None if args.skip_reference else compile_reference(td)

        # --- query workload: reads vs the 9-genome index ------------------
        ours_out = os.path.join(td, "ours_q.gz")
        t_warm = run_ours(["-I", ECOLI_FOF, "-l", fq, "-O",
                           os.path.join(td, "warm.gz")] + base)
        log(f"ours query warmup {t_warm:.1f}s")
        t_ours = run_ours(["-I", ECOLI_FOF, "-l", fq, "-O", ours_out] + base)
        if exe:
            t_ref = run_reference(
                exe, ["-I", ECOLI_FOF, "-l", fq, "-O", "ref_q.gz"] + base, td)
            ok = gzip.open(ours_out).read() == \
                gzip.open(os.path.join(td, "ref_q.gz")).read()
            log(f"reads query parity: {ok}")
            if not ok:
                print(json.dumps({"metric": "reads_query_PARITY_FAIL",
                                  "value": 0.0, "unit": "s"}))
                return 1
        else:
            t_ref = None
        print(json.dumps({
            "metric": f"reads{args.reads}_query_wall", "value": round(t_ours, 2),
            "unit": "s", "reads_per_s": round(args.reads / t_ours),
            **({"vs_reference_1thread": round(t_ref / t_ours, 1),
                "reference_s": round(t_ref, 2)} if t_ref else {})}))

        # --- index workload: -i on the same reads -------------------------
        t_warm = run_ours(["-i", fq, "-O", os.path.join(td, "w2.gz")] + base)
        t_ours = run_ours(["-i", fq, "-O", os.path.join(td, "o2.gz")] + base)
        if exe:
            t_ref = run_reference(exe, ["-i", fq, "-O", "r2.gz"] + base, td)
        print(json.dumps({
            "metric": f"reads{args.reads}_index_wall", "value": round(t_ours, 2),
            "unit": "s", "reads_per_s": round(args.reads / t_ours),
            **({"vs_reference_1thread": round(t_ref / t_ours, 1),
                "reference_s": round(t_ref, 2)} if exe else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
