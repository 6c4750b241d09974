"""Streaming NCBI ingest: download, sketch, insert — nothing kept on disk.

Rework of the reference's popen("wget | gzip -d") pipeline
(/root/reference/src/niqki_index.cpp:802-870): a thread pool streams and
gunzips assemblies with urllib + zlib, parses FASTA records incrementally,
and feeds sketches to the index; ids are assigned in fof order
(deterministic, unlike the reference's racy critical-section order).

Each accession URL <base> resolves to <base>/<name>_genomic.fna.gz where
<name> is the last path component, exactly like get_name_ncbi.
"""

from __future__ import annotations

import concurrent.futures as cf
import urllib.request

from .index import SketchIndex


def name_of_accession_url(url: str) -> str:
    """Exactly get_name_ncbi (src/niqki_index.cpp:789-798): the name starts
    after the last '/' found at positions [0, len-4] — a slash within the
    final 3 characters is never seen, so a trailing-slash URL keeps it and
    yields the same broken fetch URL (and thus skipped accession) as the
    reference."""
    last = 0   # reference inits lastposition=0: a slash-free URL drops char 0
    for i in range(max(len(url) - 3, 0)):
        if url[i] == "/":
            last = i
    return url[last + 1:]


def _iter_contigs(url: str, K: int, timeout: float, stats: dict):
    """STREAMING contigs of one accession — the decode is incremental
    (zlib.decompressobj over response chunks, multi-member aware), so RSS
    stays O(contig) like the reference's wget|gzip -d pipe
    (src/niqki_index.cpp:802-837) instead of buffering the whole
    compressed asset (+ its inflation) in RAM. Reference Download_NCBI's
    exact flush quirks are kept (src/niqki_index.cpp:810-827): a contig is
    only flushed when the NEXT '>' line is seen, so the final contig is
    always dropped; and a contig of length <= K is NOT cleared — its bases
    prepend the next contig. (Live NCBI is unreachable in the zero-egress
    test env; behavior is pinned by the loopback-HTTP differential in
    tests/test_downloader_diff.py.) ``stats['bases']`` accumulates flushed
    bases for the caller's progress counter."""
    import zlib
    full = f"{url}/{name_of_accession_url(url)}_genomic.fna.gz"
    with urllib.request.urlopen(full, timeout=timeout) as resp:
        d = zlib.decompressobj(31)          # gzip wrapper
        sequence = bytearray()
        tail = b""

        def lines_of(data):
            nonlocal tail
            buf = tail + data if tail else data
            parts = buf.split(b"\n")
            tail = parts.pop()
            return parts

        def handle(line):
            nonlocal sequence
            if not line.startswith(b">"):
                sequence += line
                return None
            if len(sequence) > K:
                out = bytes(sequence)
                sequence = bytearray()
                stats["bases"] += len(out)
                return out
            return None

        while True:
            chunk = resp.read(1 << 18)
            if not chunk:
                break
            pieces = []
            while chunk:
                if d.eof:                   # next gzip member (or garbage,
                    d = zlib.decompressobj(31)  # which raises like GzipFile)
                pieces.append(d.decompress(chunk))
                chunk = d.unused_data
            for line in lines_of(b"".join(pieces)):
                c = handle(line)
                if c is not None:
                    yield c
        if tail:                            # final line without '\n'
            c = handle(tail)
            if c is not None:
                yield c
        # the final contig (and any trailing <= K carry) is dropped —
        # reference quirk: flushed only on the next '>' line


def download_ncbi_fof(index: SketchIndex, fof_path: str,
                      max_workers: int = 8, timeout: float = 120.0,
                      progress_every: int = 1000) -> tuple[int, int]:
    """Download every accession in the fof, sketch, insert. Returns
    (genomes_downloaded, bases_downloaded). Failures are skipped silently
    (matching the reference's tolerance of dead links)."""
    with open(fof_path) as f:
        urls = [u.rstrip("\n") for u in f if len(u.rstrip("\n")) > 5]
    genomes = bases = 0
    K = index.params.K

    def work(url):
        """Stream-decode + sketch one accession INSIDE the worker: contigs
        min-merge into the sketch as they arrive (sketch_records iterates
        the generator), so worker RSS is O(contig) — download of the next
        chunk overlaps sketching of the last. Insertion order stays fof
        order on the caller's thread (deterministic ids)."""
        try:
            stats = {"bases": 0}
            sketch = index.sketch_records(_iter_contigs(url, K, timeout,
                                                        stats))
            return url, (sketch, stats["bases"])
        except Exception:
            return url, None

    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        for url, result in pool.map(work, urls):
            if not result or not result[1]:
                continue
            sketch, total = result
            index.insert_sketch(sketch, url)
            genomes += 1
            bases += total
            if genomes % progress_every == 0:
                print(f"#genomes downloaded: {genomes:,} "
                      f"#bases downloaded: {bases:,}")
    print(f"#genomes downloaded: {genomes:,} #bases downloaded: {bases:,}")
    return genomes, bases
