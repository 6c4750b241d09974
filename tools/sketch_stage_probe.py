"""Per-stage cycle breakdown of the staged host sketcher: where does its
time go — the sequential canonical roll (A), the 8-wide vectorized
hash/fingerprint (B), or the min-scatter into the 2^lF table (C)?  Stages
A and A+B run as isolated loops of the production code shape (native
nq_sketch_stage_bench); 'full' is the real sketch_packed_range.  Run on an
idle host (the probe is CPU-bound).

Run: python tools/sketch_stage_probe.py [--lF 15] [--reps 7]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lF", type=int, default=15)
    ap.add_argument("--K", type=int, default=31)
    ap.add_argument("--W", type=int, default=12)
    ap.add_argument("--H", type=int, default=4)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--path",
                    default="/root/reference/resources/ecoli01p.fa.gz")
    args = ap.parse_args()

    from niqki_tpu import native
    assert native.available()
    recs = list(native.read_packed_records(args.path, args.K))
    _, words, n, _ = max(recs, key=lambda r: r[2])
    print(f"record: {n} bases, lF={args.lF} K={args.K} "
          f"(table {4 << args.lF >> 10} KiB)", file=sys.stderr)

    best = None
    for _ in range(3):  # best-of outer reps (scheduler noise)
        d = native.sketch_stage_bench(words, n, args.lF, args.K, args.W,
                                      args.H, reps=args.reps)
        if best is None or d["full_ns"] < best["full_ns"]:
            best = d
    mbps = 1e3 / best["full_ns"]
    print(json.dumps({
        "metric": "sketch_stage_ns_per_window",
        "roll": round(best["roll_ns"], 2),
        "hash": round(best["hash_ns"], 2),
        "scatter": round(best["scatter_ns"], 2),
        "full": round(best["full_ns"], 2),
        "full_mbp_per_s_per_thread": round(mbps, 1),
        "lF": args.lF,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
