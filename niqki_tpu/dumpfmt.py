"""NIQKI-compatible index checkpoint format (dump/load).

Byte layout (gzip-wrapped binary, little-endian, all fields uint32), matching
the reference dump for interoperability
(/root/reference/src/niqki_index.cpp:42-102):

    lF, K, H, W, min_score, genome_numbers
    for each of F * 2^W flat buckets (flat key = fp + slot * 2^W):
        uint32 size, then `size` uint32 genome ids
    genome_numbers newline-terminated name strings

Because every indexed genome contributes exactly one fingerprint per slot
(sketches are fully densified), the bucket lists per slot form a partition of
all genome ids; this module converts between that inverted layout and the
dense (G, F) fingerprint matrix the engine uses natively.

A native sharded checkpoint format (v2: raw little-endian int32 row blocks —
optionally one-shot-gzip'd — plus per-shard name blobs and a JSON manifest)
lives in index.py; this module is only the parity/interop format.
"""

from __future__ import annotations

import gzip
import io
import struct

import numpy as np

from .params import SketchParams


class DumpHeader:
    def __init__(self, lF, K, H, W, min_score, genome_numbers):
        self.lF, self.K, self.H, self.W = lF, K, H, W
        self.min_score, self.genome_numbers = min_score, genome_numbers

    def params(self) -> SketchParams:
        # min_fract itself is not stored in the dump; reconstruct a value that
        # truncates back to the stored min_score exactly.
        F = 1 << self.lF
        return SketchParams(
            lF=self.lF, K=self.K, W=self.W, H=self.H,
            min_fract=self.min_score / F if self.min_score else 0.0,
        )


def load_dump(path: str, chunk_words: int = 1 << 24):
    """Parse a NIQKI dump into (header, fingerprint_matrix, names).

    fingerprint_matrix is int32 of shape (G, F); slots where a genome id never
    appears (impossible for reference-produced, fully densified indexes) stay
    -1.

    The gzip stream is consumed in ``chunk_words`` pieces through the native
    incremental scanner, so peak memory is the (G, F) matrix plus one chunk —
    NOT the decompressed dump (which is ~(1 + G/2^W) * F * 2^W words: far
    larger than the matrix whenever buckets outnumber genomes). Falls back to
    a whole-buffer parse when the native library is absent.
    """
    from . import native
    with gzip.open(path, "rb") as f:
        head = f.read(24)
        lF, K, H, W, min_score, G = struct.unpack_from("<6I", head, 0)
        hdr = DumpHeader(lF, K, H, W, min_score, G)
        F = 1 << lF
        fr = 1 << W
        n_buckets = F * fr
        sk = np.full((G, F), -1, dtype=np.int32)
        if native.available():
            scanner = native.DumpStreamScanner(n_buckets)
            tail = b""
            name_blob = []
            while True:
                data = f.read(4 * chunk_words)
                if not data:
                    break
                if scanner.done:
                    name_blob.append(data)
                    continue
                data = tail + data
                usable = len(data) // 4 * 4
                tail = data[usable:]
                words = np.frombuffer(data, dtype="<u4", count=usable // 4)
                gids, buckets, consumed = scanner.feed(words)
                if len(gids):
                    sk[gids.astype(np.int64), buckets // fr] = \
                        (buckets % fr).astype(np.int32)
                if consumed < len(words):
                    name_blob.append(data[4 * consumed:])
                    tail = b""
            if not scanner.done:
                # EOF mid-bucket-stream (disk full / partial copy): loading
                # would silently return an index with missing fingerprints.
                raise ValueError("truncated dump bucket stream")
            names_raw = (tail + b"".join(name_blob))
        else:
            data = f.read()
            words = np.frombuffer(data, dtype="<u4", count=len(data) // 4)
            sizes = np.empty(n_buckets, dtype=np.int64)
            pos = 0
            for k in range(n_buckets):
                if pos >= len(words):
                    raise ValueError("truncated dump bucket stream")
                s = int(words[pos])
                sizes[k] = s
                pos += 1 + s
            if pos > len(words):
                raise ValueError("truncated dump bucket stream")
            total = int(sizes.sum())
            bucket_of_gid = np.repeat(
                np.arange(n_buckets, dtype=np.int64), sizes)
            gid_words = words[np.arange(total, dtype=np.int64)
                              + bucket_of_gid + 1]
            sk[gid_words.astype(np.int64), bucket_of_gid // fr] = \
                (bucket_of_gid % fr).astype(np.int32)
            names_raw = data[4 * pos:]
    names = names_raw.decode("utf-8", errors="replace").split("\n")[:G]
    return hdr, sk, names


def save_dump(path: str, p: SketchParams, sketches: np.ndarray, names) -> None:
    """Write a NIQKI-compatible dump from a dense (G, F) fingerprint matrix.

    Bucket-internal gid order is ascending, which equals the reference's
    insertion order under its deterministic (single-thread) id assignment.
    """
    from . import hostmem
    G, F = sketches.shape if sketches.size else (0, p.F)
    fr = p.fingerprint_range
    n_buckets = p.F * fr
    header = struct.pack("<6I", p.lF, p.K, p.H, p.W, p.min_score, G)
    if G:
        valid = (sketches >= 0) & (sketches < fr)
        flat = (np.arange(F, dtype=np.int64)[None, :] * fr
                + sketches.astype(np.int64))
        # slot-major then gid-minor ordering: transpose before raveling.
        keys = flat.T.ravel()
        gids = np.broadcast_to(
            np.arange(G, dtype=np.uint32)[None, :], (F, G)).ravel()
        ok = valid.T.ravel()
        keys, gids = keys[ok], gids[ok]
        order = np.argsort(keys, kind="stable")
        keys, gids = keys[order], gids[order]
        # Touch ONLY the nonempty buckets: the stream has 2^(S+W) size
        # words (2^30 at S=18 W=12 — a 4.3 GB buffer), but at most G*F of
        # them are nonzero. big_zeros pages stay untouched (shared zero
        # page) everywhere the scatter doesn't reach; the old dense
        # bincount + full-starts scatter first-touched every page of
        # THREE such buffers (the hostmem pathology).
        out_words = hostmem.big_zeros(n_buckets + len(gids), "<u4")
        uniq, cnt = np.unique(keys, return_counts=True)  # keys are sorted
        gid_before = np.zeros(len(uniq), np.int64)
        np.cumsum(cnt[:-1], out=gid_before[1:])
        out_words[uniq + gid_before] = cnt.astype("<u4")
        out_words[np.arange(len(gids), dtype=np.int64) + keys + 1] = gids
    else:
        out_words = hostmem.big_zeros(n_buckets, "<u4")
    name_blob = "".join(str(n) + "\n" for n in names).encode()
    # level 1: parity is on DECOMPRESSED bytes everywhere (tests, the
    # reference's loader); level 9 on an S=18 stream (4.3 GB, mostly
    # zero words) costs minutes for nothing.
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(header)
        mv = memoryview(out_words).cast("B")
        chunk = 64 << 20     # bounded gzip input chunks (a 4.3 GB tobytes
        for lo in range(0, len(mv), chunk):  # copy would double peak RSS)
            f.write(mv[lo:lo + chunk])
        f.write(name_blob)
