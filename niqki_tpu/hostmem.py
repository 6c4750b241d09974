"""Host memory + IO primitives sized for multi-GB sketch matrices.

Two pathologies of the virtualized host the engine was first built on are
worked around here (whether the GPU host needs them is ROADMAP C4):

* **First-touch page faults are catastrophically slow** (~22 MB/s) for
  fresh 4 KB pages, so a plain ``np.empty`` of a 100k-genome matrix costs
  minutes before a single byte is copied. Transparent hugepages are in
  ``madvise`` mode, and an ``madvise(MADV_HUGEPAGE)`` on an anonymous mmap
  faults ~70x faster (1.5+ GB/s). ``big_empty`` allocates numpy arrays that
  way.
* **Page-cache population degrades the same way at GB scale** (~12 MB/s
  writes), so buffered file IO of a checkpoint shard is disk-speed in
  name only. ``write_direct``/``read_direct`` use ``O_DIRECT`` (0.5-0.7
  GB/s here), falling back to buffered IO where the filesystem refuses it
  or buffers are unaligned.

Everything degrades gracefully: on any failure the plain numpy / buffered
path is used, so behavior is identical and only speed differs.
"""

from __future__ import annotations

import ctypes
import mmap
import os

import numpy as np

_MADV_HUGEPAGE = 14
_ALIGN = 4096           # O_DIRECT alignment (logical block, worst case)
_CHUNK = 64 << 20       # per-syscall IO chunk

try:
    _libc = ctypes.CDLL("libc.so.6", use_errno=True)
except OSError:          # non-glibc platform: hugepage hint unavailable
    _libc = None


def big_empty(shape, dtype) -> np.ndarray:
    """``np.empty`` for large arrays, backed by an anonymous mmap hinted
    to transparent hugepages. Small requests (< 2 MB, under one hugepage)
    and any mmap failure fall back to ``np.empty``.

    Buffers >= 128 MB are additionally pre-faulted by a small thread pool:
    this host's first-touch rate swings between ~1.5 GB/s and ~25 MB/s on
    minute timescales (hypervisor backing-store episodes), and fault
    latency parallelizes ~4x across cores — so the slow regime costs 4x
    less and the fast regime pays ~0.4 s/GB. NIQKI_TPU_NO_PREFAULT=1
    disables it."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dt = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape else dt.itemsize
    if n < (2 << 20) or _libc is None:
        return np.empty(shape, dt)
    try:
        buf = mmap.mmap(-1, n)
    except (OSError, OverflowError, ValueError):
        return np.empty(shape, dt)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    _libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(n), _MADV_HUGEPAGE)
    arr = np.frombuffer(buf, dt, count=n // dt.itemsize).reshape(shape)
    if n >= (128 << 20) and not os.environ.get("NIQKI_TPU_NO_PREFAULT"):
        from concurrent.futures import ThreadPoolExecutor
        flat = arr.reshape(-1).view(np.uint8)
        threads = min(4, os.cpu_count() or 1)
        step = -(-n // threads)

        def touch(lo: int) -> None:
            flat[lo:lo + step:4096] = 0  # one byte per 4K page

        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(touch, range(0, n, step)))
    return arr


def big_zeros(shape, dtype) -> np.ndarray:
    """``np.zeros`` for large arrays. The mmap behind ``big_empty`` is
    anonymous and therefore already zero-filled; sparse writers (e.g. the
    2^(S+W)-bucket dump stream at S=18) rely on untouched pages staying
    zero WITHOUT being faulted in up front, so prefaulting is skipped —
    read faults map the shared zero page cheaply."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dt = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape \
        else dt.itemsize
    if n < (2 << 20) or _libc is None:
        return np.zeros(shape, dt)
    try:
        buf = mmap.mmap(-1, n)
    except (OSError, OverflowError, ValueError):
        return np.zeros(shape, dt)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    _libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(n), _MADV_HUGEPAGE)
    return np.frombuffer(buf, dt, count=n // dt.itemsize).reshape(shape)


def big_copy(arr: np.ndarray, dtype=None) -> np.ndarray:
    """``arr.astype(dtype)`` / ``arr.copy()`` into a hugepage-backed
    destination (``astype`` would first-touch a fresh buffer slowly)."""
    out = big_empty(arr.shape, dtype or arr.dtype)
    np.copyto(out, arr, casting="unsafe")
    return out


def _flat_bytes(arr: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(arr)
    return a.reshape(-1).view(np.uint8)


def _is_aligned(arr: np.ndarray) -> bool:
    return arr.ctypes.data % _ALIGN == 0


def write_direct(path: str, arr: np.ndarray) -> None:
    """Write ``arr``'s bytes to ``path``, bypassing the page cache when
    possible (O_DIRECT for the aligned bulk, a buffered tail write for the
    unaligned remainder). Byte-identical to ``open(path,'wb').write``."""
    b = _flat_bytes(arr)
    n = b.nbytes
    bulk = (n // _ALIGN) * _ALIGN
    fd = -1
    if bulk and _is_aligned(b) and hasattr(os, "O_DIRECT"):
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                         | os.O_DIRECT, 0o644)
        except OSError:      # filesystem refuses O_DIRECT (e.g. tmpfs)
            fd = -1
    if fd < 0:
        with open(path, "wb") as f:
            f.write(memoryview(b))
        return
    try:
        mv = memoryview(b)
        for lo in range(0, bulk, _CHUNK):
            written = os.write(fd, mv[lo:min(lo + _CHUNK, bulk)])
            if written != min(_CHUNK, bulk - lo):   # short write: bail out
                raise OSError("short O_DIRECT write")
    except OSError:
        os.close(fd)
        with open(path, "wb") as f:   # restart buffered from scratch
            f.write(memoryview(b))
        return
    os.close(fd)
    if n > bulk:                      # unaligned tail, buffered
        with open(path, "r+b") as f:
            f.seek(bulk)
            f.write(memoryview(b[bulk:]))


def _readinto_exact(f, mv) -> None:
    """readinto() until ``mv`` is full; raises on EOF (a truncated input
    must never silently leave zero-filled rows — fingerprint 0 is valid)."""
    got, n = 0, len(mv)
    while got < n:
        r = f.readinto(mv[got:])
        if not r:
            raise OSError(f"short read: {got} of {n} bytes")
        got += r


def read_direct(path: str, arr: np.ndarray, offset: int = 0) -> None:
    """Fill ``arr`` (C-contiguous) from ``path``'s bytes starting at
    ``offset``, O_DIRECT for the aligned bulk. The file must hold at least
    offset + arr.nbytes; raises OSError when shorter (e.g. a checkpoint
    shard truncated by a crash). A ranged read (offset > 0) lets the
    mesh-direct checkpoint loader pull one device's row range out of a
    shard file without touching the rest."""
    if not arr.flags.c_contiguous:
        raise ValueError("read_direct needs a C-contiguous destination")
    b = arr.reshape(-1).view(np.uint8)
    n = b.nbytes
    bulk = (n // _ALIGN) * _ALIGN
    fd = -1
    if bulk and _is_aligned(b) and offset % _ALIGN == 0 \
            and hasattr(os, "O_DIRECT"):
        try:
            fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            fd = -1
    if fd < 0:
        with open(path, "rb") as f:
            f.seek(offset)
            _readinto_exact(f, memoryview(b))
        return
    try:
        mv = memoryview(b)
        got = 0
        while got < bulk:
            r = os.preadv(fd, [mv[got:min(got + _CHUNK, bulk)]],
                          offset + got)
            if r <= 0:
                raise OSError("short O_DIRECT read")
            got += r
    except OSError:
        # O_DIRECT can fail for alignment/filesystem reasons; retry
        # buffered from scratch (which itself raises if the file is short).
        os.close(fd)
        with open(path, "rb") as f:
            f.seek(offset)
            _readinto_exact(f, memoryview(b))
        return
    os.close(fd)
    if n > bulk:
        with open(path, "rb") as f:
            f.seek(offset + bulk)
            _readinto_exact(f, memoryview(b[bulk:]))
