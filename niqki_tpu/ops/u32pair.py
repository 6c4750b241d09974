"""64-bit integer arithmetic as uint32 pairs.

Every hash in the engine is computed on (hi, lo) uint32 pairs, which needs
no 64-bit integer support from the backend (jax_enable_x64 stays off);
whether native u64 is faster on the GPU is an open measurement (ROADMAP
A4). Only three 64-bit operations are ever needed:

  * xor-shift-32:        y = (x >> 32) ^ x      -> (hi, lo ^ hi)
  * multiply mod 2^64:   by a compile-time constant
  * count-leading-zeros: via lax.clz on 32-bit halves

The xorshift-multiply bijections match the reference hash family
(/root/reference/src/niqki_index.cpp:291-310) bit-for-bit; constants
0xD6E8FEB86659FD93 ("rev") and 0xCFEE444D8B59A89B ("unrev").
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

REV_C = 0xD6E8FEB86659FD93
UNREV_C = 0xCFEE444D8B59A89B

# NOTE: all masks below are Python ints, never jnp scalars: a module-level
# jnp.uint32 constant becomes a captured device array instead of an
# immediate folded into the fused kernel. Weak-typed Python ints fold in.


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def umulhi32(a, b):
    """High 32 bits of a 32x32 -> 64 unsigned multiply, via 16-bit limbs."""
    a, b = _u32(a), _u32(b)
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    t0 = al * bl
    t1 = ah * bl + (t0 >> 16)          # < 2^32, no overflow
    t2 = al * bh + (t1 & 0xFFFF)       # < 2^32, no overflow
    return ah * bh + (t1 >> 16) + (t2 >> 16)


def mul64_u32(hi, lo, c: int):
    """(hi, lo) * c mod 2^64, c a Python constant."""
    c_hi = jnp.uint32((c >> 32) & 0xFFFFFFFF)
    c_lo = jnp.uint32(c & 0xFFFFFFFF)
    out_lo = lo * c_lo
    out_hi = umulhi32(lo, c_lo) + lo * c_hi + hi * c_lo
    return out_hi, out_lo


def _xorshift32(hi, lo):
    """y = (x >> 32) ^ x on pairs."""
    return hi, lo ^ hi


def _hash64(hi, lo, c: int):
    hi, lo = _xorshift32(hi, lo)
    hi, lo = mul64_u32(hi, lo, c)
    hi, lo = _xorshift32(hi, lo)
    hi, lo = mul64_u32(hi, lo, c)
    return _xorshift32(hi, lo)


def revhash64_u32(hi, lo):
    return _hash64(_u32(hi), _u32(lo), REV_C)


def unrevhash64_u32(hi, lo):
    return _hash64(_u32(hi), _u32(lo), UNREV_C)


def clz32(x):
    """Count leading zeros of uint32 (clz32(0) == 32), exactly.

    This extracts floor(log2 x) from the f32 exponent (whether lax.clz is
    faster on the GPU is an open measurement, ROADMAP A4). u32 -> f32
    conversion rounds to nearest, which can bump the exponent past the true
    floor (e.g. 2^24 - 1 -> 2^24); the (x >> e) == 0 test detects exactly
    that case and steps back. Verified exact over random and boundary inputs.
    """
    x = _u32(x)
    f = x.astype(jnp.float32)
    e = (lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127
    e = jnp.clip(e, 0, 31)
    over = (x >> e.astype(jnp.uint32)) == 0
    fl = jnp.where(over, e - 1, e)
    return jnp.where(x == 0, 32, 31 - fl).astype(jnp.int32)


def clz64_u32(hi, lo):
    """Count leading zeros of a (hi, lo) pair; clz64(0,0) == 64."""
    return jnp.where(hi == 0, 32 + clz32(lo), clz32(hi))
