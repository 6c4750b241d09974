#!/usr/bin/env python3
"""Compare two genome-distance matrices (the eval kit's accuracy check).

Counterpart of the reference's resources/parse.py (which
scatter-plots a NIQKI matrix against a Dashing matrix): reads two
gzip/plain matrix files in the "##Names\t..." format, aligns genomes by
name, and reports agreement statistics (max/mean abs diff, Pearson r).
Optionally writes a scatter plot when matplotlib is importable.

Usage: compare_matrices.py A.gz B.gz [--plot out.png]
"""

import argparse
import gzip
import math
import sys


def read_matrix(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        header = f.readline().rstrip("\n")
        if not header.startswith("##Names"):
            raise SystemExit(f"{path}: not a matrix file")
        names = [n for n in header.split("\t")[1:] if n]
        rows = {}
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            rows[parts[0]] = [float(v) for v in parts[1:] if v != ""]
    return names, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--plot", metavar="PNG")
    args = ap.parse_args()
    names_a, rows_a = read_matrix(args.a)
    names_b, rows_b = read_matrix(args.b)
    common = [n for n in names_a if n in set(names_b)]
    if not common:
        raise SystemExit("no common genome names")
    ia = {n: i for i, n in enumerate(names_a)}
    ib = {n: i for i, n in enumerate(names_b)}
    xs, ys = [], []
    for q in common:
        if q not in rows_a or q not in rows_b:
            continue
        for t in common:
            xs.append(rows_a[q][ia[t]])
            ys.append(rows_b[q][ib[t]])
    n = len(xs)
    diffs = [abs(x - y) for x, y in zip(xs, ys)]
    mx = max(diffs)
    mean = sum(diffs) / n
    sx = sum(xs) / n
    sy = sum(ys) / n
    cov = sum((x - sx) * (y - sy) for x, y in zip(xs, ys))
    vx = sum((x - sx) ** 2 for x in xs)
    vy = sum((y - sy) ** 2 for y in ys)
    r = cov / math.sqrt(vx * vy) if vx and vy else float("nan")
    print(f"pairs compared : {n} ({len(common)} genomes)")
    print(f"max |diff|     : {mx:.6g}")
    print(f"mean |diff|    : {mean:.6g}")
    print(f"pearson r      : {r:.6f}")
    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping plot", file=sys.stderr)
            return 0
        plt.figure(figsize=(5, 5))
        plt.scatter(xs, ys, s=4, alpha=0.5)
        plt.xlabel(args.a)
        plt.ylabel(args.b)
        plt.title(f"r={r:.4f}  max|d|={mx:.3g}")
        plt.savefig(args.plot, dpi=150, bbox_inches="tight")
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
