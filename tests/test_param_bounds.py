"""Parameter-validation boundary behavior.

params.py rejects lF > 24, K > 31, W > 30 up front; the reference accepts
any -S/-K/-W and degrades at runtime instead (its bucket array is
2^(S+W) vectors — S=24 or W=30 allocates beyond any real host and dies,
K > 31 silently wraps the 2K-bit rolling mask). The caps bound exactly the
region where the reference is OOM or UB, and the divergence is documented
in README's quirks table. These tests pin the ACCEPTED boundary: the
engine must actually work at lF=24, W=30, and K=2 (K=2 is additionally
fuzzed byte-for-byte against the binary in test_reference_fuzz CASES —
the only boundary the reference itself survives).
"""

import numpy as np
import pytest

from niqki_tpu import native, oracle
from niqki_tpu.params import SketchParams


def test_rejects_beyond_caps():
    for kw in ({"lF": 25}, {"lF": 0}, {"K": 32}, {"K": 1}, {"W": 31},
               {"W": 0}, {"H": 13}):
        with pytest.raises(ValueError):
            SketchParams(**kw)
    # the boundary itself is accepted
    SketchParams(lF=24)
    SketchParams(W=30, H=4)
    SketchParams(K=2)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_lf24_small_genome():
    """lF=24 (F=16M slots, the -S cap): a small genome sketches, densifies
    (native O(distinct)/pass algebraic densifier — the oracle's literal
    scan is impractical at this F), and self-counts to exactly F. The
    pre-densification table is cross-checked against the device kernel."""
    p = SketchParams(lF=24)
    rng = np.random.default_rng(7)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 20_000).tobytes()
    ef, er = oracle.encode_record(seq, p.K)
    table = native.sketch_codes_cpu(ef, er, p.lF, p.K, p.W, p.H)
    from niqki_tpu.ops.sketch import sketch_codes
    dev = sketch_codes(ef, er, p)           # pre-densify, INT32_MAX empty
    assert (table == dev).all()
    sk = np.where(table == np.iinfo(np.int32).max, -1, table).astype(np.int32)
    native.densify(sk)
    assert (sk != -1).all()                  # fully densified
    c = native.count_eq(sk[None, :], sk[None, :], p.fingerprint_range)
    assert c[0, 0] == p.F


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_w30_fingerprints():
    """W=30 (the -W cap): 30-bit fingerprints through oracle, native and
    the device kernel, then self/cross counts through the index's W>14
    int32 route — all identical."""
    p = SketchParams(lF=8, W=30, H=4)
    rng = np.random.default_rng(8)
    from niqki_tpu import SketchIndex
    idx = SketchIndex(p)
    idxn = SketchIndex(p, backend="numpy")
    seqs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000).tobytes()
            for _ in range(4)]
    for i, s in enumerate(seqs):
        ef, er = oracle.encode_record(s, p.K)
        table = native.sketch_codes_cpu(ef, er, p.lF, p.K, p.W, p.H,
                                        p.mask_M, p.maximal_remainder)
        fwd, rc = oracle.kmers_from_codes(ef, er, p.K)
        slot, fp = oracle.slots_and_fingerprints(np.minimum(fwd, rc), p)
        want = np.full(p.F, np.iinfo(np.int32).max, np.int32)
        np.minimum.at(want, slot, fp)
        from niqki_tpu.ops.sketch import sketch_codes
        dev = sketch_codes(ef, er, p)
        assert (table == want).all()
        assert (table == dev).all()
        sk = idx.sketch_records([s])
        skn = idxn.sketch_records([s])
        assert (sk == skn).all()
        idx.insert_sketch(sk, f"g{i}")
        idxn.insert_sketch(skn, f"g{i}")
    q = idx.matrix()
    assert (idx.counts(q) == idxn.counts(q)).all()
