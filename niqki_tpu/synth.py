"""Synthetic genomes for benchmarks and smoke runs, made from a seed.

Clustered point-mutants of random ancestors: each cluster is one uniform
random ancestor, and each member replaces every base independently with
probability ``mut`` by a uniform draw (which may redraw the same base, so
the effective divergence is ~0.75 * mut). Queries drawn from such a set hit
a whole cluster, the skewed workload that unrelated random genomes (near
zero counts) never exercise. Nothing here touches the device.
"""

from __future__ import annotations

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """(length,) uint8 ASCII bases, uniform over ACGT."""
    return ALPHABET[rng.integers(0, 4, length, dtype=np.uint8)]


def mutants(rng: np.random.Generator, ancestor: np.ndarray, n: int,
            mut: float) -> np.ndarray:
    """(n, len) uint8 point-mutants of ``ancestor`` at per-base rate mut."""
    L = len(ancestor)
    hit = rng.random((n, L), dtype=np.float32) < mut
    draw = ALPHABET[rng.integers(0, 4, (n, L), dtype=np.uint8)]
    return np.where(hit, draw, ancestor[None, :])


def clustered_genomes(rng: np.random.Generator, n: int, length: int,
                      clusters: int, mut: float = 0.02):
    """Yield (cluster, seq) for n genomes in ``clusters`` clusters of
    near-equal size, cluster by cluster."""
    for c in range(clusters):
        k = n // clusters + (1 if c < n % clusters else 0)
        anc = random_genome(rng, length)
        for seq in mutants(rng, anc, k, mut):
            yield c, seq


def write_fasta(path: str, records, line: int = 0) -> None:
    """Write [(header, seq uint8 array or bytes)] as FASTA; ``line`` > 0
    wraps sequence lines at that width."""
    with open(path, "wb") as f:
        for header, seq in records:
            s = seq.tobytes() if isinstance(seq, np.ndarray) else bytes(seq)
            f.write(b">" + header.encode() + b"\n")
            if line > 0:
                for lo in range(0, len(s), line):
                    f.write(s[lo:lo + line] + b"\n")
            else:
                f.write(s + b"\n")


def write_fof(path: str, entries) -> None:
    with open(path, "w") as f:
        f.write("\n".join(entries) + "\n")


def messy(rng: np.random.Generator, seq: np.ndarray, n_runs: int = 8,
          run_len: int = 5000, lower_frac: float = 0.1) -> np.ndarray:
    """A copy of ``seq`` with ``n_runs`` runs of N and a lowercase stretch:
    the non-ACGT and soft-masked input real assemblies carry."""
    out = seq.copy()
    L = len(out)
    for s in rng.integers(0, max(1, L - run_len), n_runs):
        out[s:s + run_len] = ord("N")
    lo = int(rng.integers(0, max(1, L - int(L * lower_frac))))
    out[lo:lo + int(L * lower_frac)] |= 0x20      # ASCII lowercase
    return out

