"""ctypes bindings for the native host runtime (native/niqki_host.cpp).

The C++ library owns the host-side hot path — gzip decode, FASTA/FASTQ
parsing, 2-bit encoding — plus the small inherently-sequential routines
(densification, rolling CPU sketcher). Everything degrades gracefully to the
pure-Python implementations when the library is absent; ``available()``
reports which path is active.

The library is built with ``make -C native`` (plain g++ + zlib, no pybind11);
on first import this module attempts that build automatically if the shared
object is missing (disable with NIQKI_TPU_NO_NATIVE_BUILD=1, force-disable
the native path entirely with NIQKI_TPU_NO_NATIVE=1).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libniqki_host.so")

_lib = None
_tried = False


def _try_build() -> None:
    if os.environ.get("NIQKI_TPU_NO_NATIVE_BUILD"):
        return
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        pass


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("NIQKI_TPU_NO_NATIVE"):
        return None
    if not os.path.exists(_SO_PATH):
        _try_build()
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.nq_reader_open.restype = ctypes.c_void_p
    lib.nq_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int]
    lib.nq_reader_next.restype = ctypes.c_int
    lib.nq_reader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.nq_reader_close.restype = None
    lib.nq_reader_close.argtypes = [ctypes.c_void_p]
    lib.nq_densify.restype = None
    lib.nq_densify.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    lib.nq_sketch_codes.restype = None
    lib.nq_sketch_codes.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.nq_reader_next_packed.restype = ctypes.c_int
    lib.nq_reader_next_packed.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.nq_scan_dump_sizes.restype = ctypes.c_int64
    lib.nq_scan_dump_sizes.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")]
    lib.nq_scan_dump_stream.restype = ctypes.c_int64
    lib.nq_scan_dump_stream.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.nq_sketch_packed_batch.restype = None
    lib.nq_sketch_packed_batch.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.nq_reader_next_chunk.restype = ctypes.c_int64
    lib.nq_reader_next_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.nq_count_eq.restype = None
    lib.nq_count_eq.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.nq_sketch_packed_whole.restype = None
    lib.nq_sketch_packed_whole.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.nq_sketch_packed_whole_mt.restype = None
    lib.nq_sketch_packed_whole_mt.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.nq_format_hits.restype = ctypes.c_int64
    lib.nq_format_hits.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p, ctypes.c_int64]
    lib.nq_format_matrix_sparse.restype = ctypes.c_int64
    lib.nq_format_matrix_sparse.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.nq_format_matrix_dense.restype = ctypes.c_int64
    lib.nq_format_matrix_dense.argtypes = [
        np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.nq_format_hits_sparse.restype = ctypes.c_int64
    lib.nq_format_hits_sparse.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_char_p, ctypes.c_int64]
    lib.nq_pack_bitplanes.restype = ctypes.c_int64
    lib.nq_pack_bitplanes.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.nq_gzip_bound.restype = ctypes.c_int64
    lib.nq_gzip_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.nq_gzip_member.restype = ctypes.c_int64
    lib.nq_gzip_member.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.nq_sketch_stage_bench.restype = ctypes.c_int64
    lib.nq_sketch_stage_bench.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.nq_abi_version.restype = ctypes.c_int64
    lib.nq_abi_version.argtypes = []
    if lib.nq_abi_version() != 11:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_encoded_records(path: str, K: int,
                         ftype: str | None = None
                         ) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Yield (header, eff_fwd, eff_rc) for records with length > K.

    Same record semantics as io.fasta.read_records + oracle.encode_record,
    but gzip decode / parse / encode all run in C++ (and release the GIL, so
    a thread pool parallelizes across files).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ft = {None: 0, "A": 1, "Q": 2}[ftype]
    h = lib.nq_reader_open(path.encode(), K, ft)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        hdr = ctypes.c_char_p()
        hlen = ctypes.c_int64()
        pf = ctypes.c_void_p()
        pr = ctypes.c_void_p()
        slen = ctypes.c_int64()
        while lib.nq_reader_next(h, ctypes.byref(hdr), ctypes.byref(hlen),
                                 ctypes.byref(pf), ctypes.byref(pr),
                                 ctypes.byref(slen)) == 1:
            n = slen.value
            eff_fwd = np.ctypeslib.as_array(
                ctypes.cast(pf, ctypes.POINTER(ctypes.c_uint8)), (n,)).copy()
            eff_rc = np.ctypeslib.as_array(
                ctypes.cast(pr, ctypes.POINTER(ctypes.c_uint8)), (n,)).copy()
            header = ctypes.string_at(hdr, hlen.value).decode(
                "utf-8", "replace")
            yield header, eff_fwd, eff_rc
    finally:
        lib.nq_reader_close(h)


def read_packed_records(path: str, K: int,
                        ftype: str | None = None
                        ) -> Iterator[Tuple[str, np.ndarray, int, np.ndarray]]:
    """Yield (header, packed_words, n_bases, exc_idx) per record (len > K).

    packed_words: uint32 array, base i's forward code in bits 2*(i%16) of
    word i//16. exc_idx: int32 positions (>= K-1) where the true reverse-
    complement code is 0 instead of the derived 3 - fwd (non-ACGT chars).
    This is the wire format of the device ingest path: 2 bits/base.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ft = {None: 0, "A": 1, "Q": 2}[ftype]
    h = lib.nq_reader_open(path.encode(), K, ft)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        hdr = ctypes.c_char_p()
        hlen = ctypes.c_int64()
        pw = ctypes.c_void_p()
        nw = ctypes.c_int64()
        pe = ctypes.c_void_p()
        ne = ctypes.c_int64()
        slen = ctypes.c_int64()
        while lib.nq_reader_next_packed(
                h, ctypes.byref(hdr), ctypes.byref(hlen), ctypes.byref(pw),
                ctypes.byref(nw), ctypes.byref(pe), ctypes.byref(ne),
                ctypes.byref(slen)) == 1:
            words = np.ctypeslib.as_array(
                ctypes.cast(pw, ctypes.POINTER(ctypes.c_uint32)),
                (nw.value,)).copy()
            if ne.value:
                exc = np.ctypeslib.as_array(
                    ctypes.cast(pe, ctypes.POINTER(ctypes.c_int32)),
                    (ne.value,)).copy()
            else:
                exc = np.zeros(0, np.int32)
            header = ctypes.string_at(hdr, hlen.value).decode(
                "utf-8", "replace")
            yield header, words, slen.value, exc
    finally:
        lib.nq_reader_close(h)


def _as_np(ptr, n, ctype, np_dtype):
    if n == 0:
        return np.zeros(0, np_dtype)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,)).astype(np_dtype,
                                                              copy=True)


def read_packed_records_chunked(path: str, K: int, ftype: str | None = None,
                                max_records: int = 1 << 15,
                                max_bases: int = 1 << 26):
    """Yield (header, packed_words, n_bases, exc_idx) per record like
    read_packed_records, but via chunked native reads: ONE ctypes call per
    ~max_records records, with per-record numpy views into the chunk's
    concatenated buffers (the per-record ctypes round-trip measured ~20 us
    of Python per record — 10x the C++ work at 150 bp read scale)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ft = {None: 0, "A": 1, "Q": 2}[ftype]
    h = lib.nq_reader_open(path.encode(), K, ft)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        pw = ctypes.c_void_p()
        pwo = ctypes.c_void_p()
        pnb = ctypes.c_void_p()
        pe = ctypes.c_void_p()
        peo = ctypes.c_void_p()
        ph = ctypes.c_char_p()
        pho = ctypes.c_void_p()
        while True:
            n = lib.nq_reader_next_chunk(
                h, max_records, max_bases, ctypes.byref(pw),
                ctypes.byref(pwo), ctypes.byref(pnb), ctypes.byref(pe),
                ctypes.byref(peo), ctypes.byref(ph), ctypes.byref(pho))
            if n == 0:
                return
            word_off = _as_np(pwo, n + 1, ctypes.c_int64, np.int64)
            n_bases = _as_np(pnb, n, ctypes.c_int64, np.int64)
            exc_off = _as_np(peo, n + 1, ctypes.c_int64, np.int64)
            header_off = _as_np(pho, n + 1, ctypes.c_int64, np.int64)
            nw, ne = int(word_off[-1]), int(exc_off[-1])
            if nw * 4 >= (1 << 21):
                from . import hostmem
                words = hostmem.big_empty((nw,), np.uint32)
                np.copyto(words, np.ctypeslib.as_array(
                    ctypes.cast(pw, ctypes.POINTER(ctypes.c_uint32)), (nw,)))
            else:
                words = _as_np(pw, nw, ctypes.c_uint32, np.uint32)
            exc = _as_np(pe, ne, ctypes.c_int32, np.int32)
            headers = ctypes.string_at(ph, int(header_off[-1]))
            for i in range(n):
                yield (headers[header_off[i]:header_off[i + 1]].decode(
                           "utf-8", "replace"),
                       words[word_off[i]:word_off[i + 1]],
                       int(n_bases[i]),
                       exc[exc_off[i]:exc_off[i + 1]])
    finally:
        lib.nq_reader_close(h)


def sketch_packed_batch(recs, lF: int, K: int, W: int, H: int,
                        mask_M: int | None = None,
                        max_rem: int | None = None) -> np.ndarray:
    """Final (-1 sentinel, densified) sketches for a batch of packed
    (words, n_bases, exc_idx) records — ONE ctypes call for the whole batch
    (the per-record Python cost of driving sketch_codes_cpu dominates at
    read scale). Bit-exact with the device kernel + host densify."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if mask_M is None:
        mask_M = (1 << (W - H)) - 1
    if max_rem is None:
        max_rem = (1 << H) - 1
    B = len(recs)
    F = 1 << lF
    if B * F * 4 >= (1 << 21):
        # Fresh np.empty pages first-touch at ~6-22 MB/s on this host class
        # (the C++ write loop would eat ~600 us/record in page faults at
        # read scale); hugepage-backed buffers fault at 1+ GB/s.
        from . import hostmem
        out = hostmem.big_empty((B, F), np.int32)
    else:
        out = np.empty((B, F), np.int32)
    if B == 0:
        return out
    lib.nq_sketch_packed_batch(*_concat_recs(recs),
                               B, K, lF, W, H, mask_M, max_rem, out)
    return out


def _concat_recs(recs):
    """(words, word_off, n_bases, exc, exc_off) concatenated wire arrays
    for a list of packed (words, n_bases, exc_idx) records."""
    B = len(recs)
    words = np.concatenate([np.ascontiguousarray(r[0], np.uint32)
                            for r in recs])
    word_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(r[0]) for r in recs], out=word_off[1:])
    n_bases = np.array([r[1] for r in recs], np.int64)
    excs = [np.ascontiguousarray(r[2], np.int32) for r in recs]
    exc = np.concatenate(excs) if any(len(e) for e in excs) \
        else np.zeros(1, np.int32)
    exc_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(e) for e in excs], out=exc_off[1:])
    return words, word_off, n_bases, exc, exc_off


def sketch_packed_whole(recs, lF: int, K: int, W: int, H: int,
                        mask_M: int | None = None,
                        max_rem: int | None = None,
                        threads: int = 1) -> np.ndarray:
    """Whole-FILE sketch of a list of packed (words, n_bases, exc_idx)
    records: per-record min-merge into one (F,) sketch with densification
    after each record, exactly the reference's multi-record accumulation
    (compute_sketch re-called on the same vector). Bit-exact with
    index._finalize_tables over per-record device tables.

    threads > 1 splits each record's window range across C++ threads
    (chunked roll + per-slot min-merge — bit-identical, records below
    ~512k windows/thread stay single-threaded); the GIL is released
    either way."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if mask_M is None:
        mask_M = (1 << (W - H)) - 1
    if max_rem is None:
        max_rem = (1 << H) - 1
    out = np.empty(1 << lF, np.int32)
    if not recs:
        out.fill(-1)
        return out
    if threads > 1:
        lib.nq_sketch_packed_whole_mt(*_concat_recs(recs), len(recs),
                                      K, lF, W, H, mask_M, max_rem,
                                      threads, out)
    else:
        lib.nq_sketch_packed_whole(*_concat_recs(recs), len(recs),
                                   K, lF, W, H, mask_M, max_rem, out)
    return out


def count_eq(q: np.ndarray, mat: np.ndarray, fp_range: int,
             threads: int | None = None) -> np.ndarray:
    """Host equality counts: (Q, G) int32 of per-slot fingerprint matches of
    q (Q, F) against mat (G, F), with the reference's query-side range guard
    (out-of-range query fingerprints match nothing) applied in C++.

    q is the RAW query sketch batch (-1 empties included); mat is the
    stored-side matrix (index._stored(): its bad slots are already -2).
    Bit-identical with the XLA/Pallas count kernels. Parallelized over Q
    blocks on a thread pool (the C call releases the GIL)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    q = np.ascontiguousarray(q, np.int32)
    mat = np.ascontiguousarray(mat, np.int32)
    Q, F = q.shape
    G = mat.shape[0]
    assert mat.shape[1] == F
    if Q * G * 4 >= (1 << 21):
        from . import hostmem
        out = hostmem.big_empty((Q, G), np.int32)  # C++ first-touches it
    else:
        out = np.empty((Q, G), np.int32)
    if Q == 0 or G == 0:
        return out
    threads = threads or min(8, os.cpu_count() or 1)
    block = max(64, -(-Q // threads))
    if Q <= block:
        lib.nq_count_eq(q, Q, mat, G, F, fp_range, out)
        return out
    from concurrent.futures import ThreadPoolExecutor

    def run(lo: int) -> None:
        hi = min(lo + block, Q)
        lib.nq_count_eq(q[lo:hi], hi - lo, mat, G, F, fp_range, out[lo:hi])

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(run, range(0, Q, block)))
    return out


class _FmtBuf:
    """Grow-only reusable output buffer for the native formatters: a fresh
    ctypes.create_string_buffer per block both memsets the whole capacity
    and (at matrix scale, ~150 MB per 768-row block) gets mmap'd/munmap'd
    by glibc every call — re-faulting fresh pages each block is exactly the
    hostmem first-touch pathology. One buffer lives as long as the
    formatter; exactly n bytes are copied out per call."""

    def __init__(self):
        self._cap = 0
        self._buf = None

    def get(self, cap: int):
        if cap > self._cap:
            self._cap = max(cap, self._cap * 2)
            self._buf = ctypes.create_string_buffer(self._cap)
        return self._buf


class HitsFormatter:
    """Formats pretty-hit rows for counts blocks in C++ — byte-identical
    with write_pretty_hits(index.hits_from_counts(...)) but ~30x faster at
    read scale (no per-hit Python tuples or %-formatting). Caches the
    genome-name blob across blocks."""

    def __init__(self, names, F: int, min_score: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.F = F
        self.min_score = min_score
        blobs = [str(n).encode() for n in names]
        self._names = b"".join(blobs)
        self._name_off = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=self._name_off[1:])
        self._max_name = max((len(b) for b in blobs), default=0)
        self.G = len(blobs)
        self._obuf = _FmtBuf()

    def format(self, counts: np.ndarray, headers: list[str]) -> bytes:
        counts = np.ascontiguousarray(counts, np.int32)
        B, G = counts.shape
        assert G + 1 == len(self._name_off) and B == len(headers)
        hb = [h.encode() for h in headers]
        hblob = b"".join(hb)
        hoff = np.zeros(B + 1, np.int64)
        np.cumsum([len(b) for b in hb], out=hoff[1:])
        nhits = int((counts >= self.min_score).sum())
        cap = len(hblob) + 2 * B + nhits * (self._max_name + 16) + 64
        out = self._obuf.get(cap)
        n = self._lib.nq_format_hits(counts, B, G, self.min_score, self.F,
                                     self._names, self._name_off, hblob,
                                     hoff, out, cap)
        if n < 0:
            raise RuntimeError("nq_format_hits capacity underestimated")
        return ctypes.string_at(out, n)

    def format_sparse(self, vals: np.ndarray, idx: np.ndarray,
                      headers: list[str]) -> bytes:
        """Rows from device-compacted top-k (vals, idx) (B, cap) —
        byte-identical with format() whenever each row's full survivor set
        fits in cap (callers re-fetch overflowing rows dense)."""
        vals = np.ascontiguousarray(vals, np.int32)
        idx = np.ascontiguousarray(idx, np.int32)
        B, kcap = vals.shape
        assert B == len(headers)
        hb = [h.encode() for h in headers]
        hblob = b"".join(hb)
        hoff = np.zeros(B + 1, np.int64)
        np.cumsum([len(b) for b in hb], out=hoff[1:])
        nhits = int((vals >= self.min_score).sum())
        cap = len(hblob) + 2 * B + nhits * (self._max_name + 16) + 64
        out = self._obuf.get(cap)
        G = len(self._name_off) - 1
        n = self._lib.nq_format_hits_sparse(
            vals, idx, B, kcap, G, self.min_score, self.F,
            self._names, self._name_off, hblob, hoff, out, cap)
        if n < 0:
            raise RuntimeError("nq_format_hits_sparse failed: capacity or "
                               "survivor contract violated")
        return ctypes.string_at(out, n)


class MatrixFormatter:
    """Formats dense all-vs-all matrix rows in C++ — byte-identical with
    io.writers.write_matrix_row over full count rows (reference
    /root/reference/src/niqki_index.cpp:747-763). Two input forms: sparse
    (device-compacted top-k survivors; min_score >= 1) and dense ((B, G)
    uint16 wrapped counts). Caches the index name blob across blocks."""

    def __init__(self, names, F: int, min_score: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.F = F
        self.min_score = min_score
        blobs = [str(n).encode() for n in names]
        self._names = b"".join(blobs)
        self._name_off = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=self._name_off[1:])
        self._max_name = max((len(b) for b in blobs), default=0)
        self.G = len(blobs)
        self._obuf = _FmtBuf()

    def format_sparse(self, vals: np.ndarray, idx: np.ndarray,
                      row0: int) -> bytes:
        vals = np.ascontiguousarray(vals, np.int32)
        idx = np.ascontiguousarray(idx, np.int32)
        B, cap = vals.shape
        nsurv = int((vals >= self.min_score).sum())
        out_cap = 2 * B * self.G + nsurv * 14 + B * (self._max_name + 4) + 64
        out = self._obuf.get(out_cap)
        n = self._lib.nq_format_matrix_sparse(
            vals, idx, B, cap, self.G, self.F, self.min_score,
            self._names, self._name_off, row0, out, out_cap)
        if n < 0:
            raise RuntimeError(f"nq_format_matrix_sparse failed ({n}): "
                               "capacity or survivor contract violated")
        return ctypes.string_at(out, n)

    def format_dense(self, counts: np.ndarray, row0: int) -> bytes:
        counts = np.ascontiguousarray(counts, np.uint16)
        B, G = counts.shape
        assert G == self.G
        nnz = int(((counts >= max(self.min_score, 1))).sum())
        out_cap = 2 * B * G + nnz * 14 + B * (self._max_name + 4) + 64
        out = self._obuf.get(out_cap)
        n = self._lib.nq_format_matrix_dense(
            counts, B, G, self.F, self.min_score,
            self._names, self._name_off, row0, out, out_cap)
        if n < 0:
            raise RuntimeError("nq_format_matrix_dense capacity "
                               "underestimated")
        return ctypes.string_at(out, n)


def pack_bitplanes(mat: np.ndarray, W: int, out: np.ndarray) -> bool:
    """AVX-512 bit-plane pack of (N, F) int32 rows into ``out`` — a
    (W+1, N, L) uint32 array or view whose last two axes are C-contiguous
    (the plane stride may exceed N*L: checkpoint loaders pack into row
    slices of a bigger planes buffer). Bit-identical with the numpy
    ops/bcount.np_pack_bitplanes body it accelerates. Returns False when
    the native lib is unavailable or the layout doesn't fit (callers fall
    back to the numpy path)."""
    lib = _load()
    if lib is None:
        return False
    m = np.ascontiguousarray(mat, np.int32)
    N, F = m.shape
    L = F // 32
    if out.dtype != np.uint32 or out.shape != (W + 1, N, L):
        return False
    s0, s1, s2 = out.strides
    if s2 != 4 or s1 != L * 4 or s0 % 4 != 0:
        return False
    return lib.nq_pack_bitplanes(m, N, F, W, out.ctypes.data, s0 // 4) == 0


_gz_tls = None


def gzip_member(data, level: int = 6) -> bytes | None:
    """One independent gzip member of ``data`` (bytes/memoryview),
    libdeflate-compressed (~2-4x zlib's deflate at comparable ratios; zlib
    fallback inside the C side). Used by io.writers.GzTextWriter, whose
    multi-member output contract is on DECOMPRESSED bytes. Thread-safe
    (the writer deflates members on a pool); the output staging buffer is
    thread-local so GB-scale matrix writes don't first-touch fresh 4 MB of
    pages per member (hostmem pathology). Returns None when the native lib
    is unavailable — callers fall back to zlib."""
    global _gz_tls
    lib = _load()
    if lib is None:
        return None
    if _gz_tls is None:
        import threading
        _gz_tls = threading.local()
    src = np.frombuffer(data, np.uint8)
    n = src.size
    cap = int(lib.nq_gzip_bound(n, level))
    buf = getattr(_gz_tls, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.empty(max(cap, 1 << 20), np.uint8)
        _gz_tls.buf = buf
    m = lib.nq_gzip_member(src.ctypes.data, n, level,
                           buf.ctypes.data, buf.size)
    if m < 0:
        return None
    return buf[:m].tobytes()


def sketch_stage_bench(words: np.ndarray, n_bases: int, lF: int, K: int,
                       W: int, H: int, reps: int = 5) -> dict:
    """Per-stage ns/window of the staged host sketcher over one packed
    record: 'roll' (sequential canonical roll), 'roll+hash' (+ the
    vectorized hash/fingerprint/slot stage), 'full' (the production
    sketch_packed_range incl. the min-scatter). tools/sketch_stage_probe.py
    is the driver; numbers feed the README sketcher roofline table."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.zeros(3, np.float64)
    mask_M = (1 << (W - H)) - 1
    max_rem = (1 << H) - 1
    r = lib.nq_sketch_stage_bench(np.ascontiguousarray(words, np.uint32),
                                  n_bases, K, lF, W, H, mask_M, max_rem,
                                  reps, out)
    if r < 0:
        raise ValueError("record too short")
    return {"roll_ns": out[0], "roll_hash_ns": out[1], "full_ns": out[2],
            "scatter_ns": out[2] - out[1], "hash_ns": out[1] - out[0]}


def densify(sketch: np.ndarray) -> None:
    """In-place densification; bit-exact with oracle.densify."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    assert sketch.dtype == np.int32 and sketch.flags.c_contiguous
    lib.nq_densify(sketch, sketch.shape[0])


def scan_dump_sizes(words: np.ndarray, n_buckets: int) -> np.ndarray:
    """Per-bucket sizes of a NIQKI dump's [size][gids...] stream.

    Returns a uint32 array of n_buckets sizes; raises on a truncated stream.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    words = np.ascontiguousarray(words, np.uint32)
    sizes = np.empty(n_buckets, np.uint32)
    total = lib.nq_scan_dump_sizes(words, len(words), n_buckets, sizes)
    if total < 0:
        raise ValueError("truncated dump bucket stream")
    return sizes


class DumpStreamScanner:
    """Incremental scanner over a NIQKI dump's [size][gids...] bucket
    stream: feed uint32 word chunks, get (gids, buckets, consumed) back;
    `done` flips once all n_buckets are consumed (remaining words = names).
    """

    def __init__(self, n_buckets: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.n_buckets = n_buckets
        self._bucket = ctypes.c_int64(0)
        self._remaining = ctypes.c_int64(0)

    @property
    def done(self) -> bool:
        return self._bucket.value >= self.n_buckets

    def feed(self, words: np.ndarray):
        words = np.ascontiguousarray(words, np.uint32)
        gids = np.empty(len(words), np.uint32)
        buckets = np.empty(len(words), np.int64)
        consumed = ctypes.c_int64(0)
        n = self._lib.nq_scan_dump_stream(
            words, len(words), self.n_buckets,
            ctypes.byref(self._bucket), ctypes.byref(self._remaining),
            ctypes.byref(consumed), gids, buckets)
        return gids[:n], buckets[:n], consumed.value


def sketch_codes_cpu(eff_fwd: np.ndarray, eff_rc: np.ndarray,
                     lF: int, K: int, W: int, H: int,
                     mask_M: int | None = None, max_rem: int | None = None,
                     table: np.ndarray | None = None) -> np.ndarray:
    """Rolling-window CPU sketcher; min-merges into ``table`` (INT32_MAX
    empty sentinel). Bit-exact with the device kernel pre-densification.
    mask_M/max_rem default to the H-derived values; the -G path passes the
    stale constants."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if table is None:
        table = np.full(1 << lF, np.iinfo(np.int32).max, np.int32)
    if mask_M is None:
        mask_M = (1 << (W - H)) - 1
    if max_rem is None:
        max_rem = (1 << H) - 1
    eff_fwd = np.ascontiguousarray(eff_fwd, np.uint8)
    eff_rc = np.ascontiguousarray(eff_rc, np.uint8)
    lib.nq_sketch_codes(eff_fwd, eff_rc, len(eff_fwd), K, lF, W, H,
                        mask_M, max_rem, table)
    return table
