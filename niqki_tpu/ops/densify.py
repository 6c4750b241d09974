"""On-device sketch densification (exact, sequential semantics).

Densification is inherently order-sequential and value-dependent
(/root/reference/src/niqki_index.cpp:313-331): ascending slot scan, target =
hash_family(value, step) % F keyed on the *value*, fills visible within the
same pass, step bumps per pass. It cannot be parallelized while preserving
bit-parity, so the production host path runs it in NumPy/C++; this lax
version exists so the *entire* pipeline can live inside one jit (graft entry,
multichip dryrun, fused ingest paths) with identical results.

Only the low 32 bits of hash_family matter because F is a power of two, so
target = (unrevhash_lo(v) + step * revhash_lo(v)) mod 2^32 & (F-1) — all
uint32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import u32pair as u
from .sketch import INT32_MAX


def _hash_lo(vals_u32):
    """Low 32 bits of revhash64/unrevhash64 of a value < 2^32 (hi word 0)."""
    rev_hi, rev_lo = u.revhash64_u32(jnp.zeros_like(vals_u32), vals_u32)
    unrev_hi, unrev_lo = u.unrevhash64_u32(jnp.zeros_like(vals_u32), vals_u32)
    del rev_hi, unrev_hi
    return rev_lo, unrev_lo


@functools.partial(jax.jit, static_argnames=("lF",))
def densify_device(table: jnp.ndarray, *, lF: int) -> jnp.ndarray:
    """Densify an (F,) int32 table with INT32_MAX empty sentinel.

    Returns the densified table (still INT32_MAX-sentinel convention).
    """
    F = 1 << lF
    mask = jnp.uint32(F - 1)

    def pass_body(state):
        table, empty, prev_empty, step = state
        prev_empty = empty

        def slot_body(i, inner):
            table, empty = inner
            v = table[i]

            def fill(args):
                table, empty = args
                vu = v.astype(jnp.uint32)
                rev_lo, unrev_lo = _hash_lo(vu)
                t = ((unrev_lo + step.astype(jnp.uint32) * rev_lo) & mask
                     ).astype(jnp.int32)
                hit = table[t] == INT32_MAX
                table = table.at[t].set(
                    jnp.where(hit, v, table[t]))
                empty = empty - hit.astype(jnp.int32)
                return table, empty

            return jax.lax.cond(
                (v != INT32_MAX) & (empty > 0), fill, lambda a: a,
                (table, empty))

        table, empty = jax.lax.fori_loop(0, F, slot_body, (table, empty))
        return table, empty, prev_empty, step + 1

    # Termination divergence (matches oracle.densify / nq_densify): the
    # reference loops forever when no value can ever reach an empty slot
    # (e.g. a poly-N record's only fingerprint is 0 and revhash64(0) == 0,
    # pinning every probe). `movable` — any value whose probe stride rev%F
    # is nonzero — is invariant (fills only copy existing values), so a
    # zero-fill pass without it can never change; a pass cap backstops.
    valid0 = table != INT32_MAX
    rev0, _ = _hash_lo(jnp.where(valid0, table, 0).astype(jnp.uint32))
    movable = jnp.any(valid0 & ((rev0 & mask) != 0))

    def cond(state):
        _, empty, prev_empty, step = state
        stuck = (empty == prev_empty) & ((~movable) | (step > 4 * F))
        return (empty > 0) & ~stuck

    empty = jnp.sum((table == INT32_MAX).astype(jnp.int32))
    # An all-empty table has nothing to copy; densifying it would never
    # terminate, so it is returned unchanged (callers exclude this case).
    table = jax.lax.cond(
        (empty > 0) & (empty < F),
        lambda t: jax.lax.while_loop(
            cond, pass_body, (t, empty, jnp.int32(-1), jnp.int32(0)))[0],
        lambda t: t,
        table,
    )
    return table
