"""Fingerprint-match counting: the query engine's hot kernel.

Dense replacement for the reference's posting-list scans and its
all-buckets atomic sweep (/root/reference/src/niqki_index.cpp:570-628,
633-687): because every sketch has exactly one fingerprint per slot, the
whole inverted index is a dense (G, F) int matrix and hit counting is

    counts[q, g] = sum_i [Q[q, i] == X[g, i]]

a blocked equality-count contraction with perfect memory locality — no
pointer chasing, no atomics, no locks; identical counts to the reference
by construction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("block_q",))
def match_counts_blocked(q_sk: jnp.ndarray, g_sk: jnp.ndarray,
                         block_q: int = 128) -> jnp.ndarray:
    """counts (Q, G) int32 from sketches q_sk (Q, F) and g_sk (G, F).

    Processes queries in blocks so peak memory stays at block_q * G * F
    fused-compare elements; XLA fuses the broadcast-compare into the
    reduction without materializing the full boolean tensor.
    """
    Q, F = q_sk.shape
    Qp = (Q + block_q - 1) // block_q * block_q
    qp = jnp.pad(q_sk, ((0, Qp - Q), (0, 0)))
    blocks = qp.reshape(Qp // block_q, block_q, F)

    def one_block(qb):
        return jnp.sum(
            (qb[:, None, :] == g_sk[None, :, :]), axis=-1, dtype=jnp.int32)

    counts = jax.lax.map(one_block, blocks)
    return counts.reshape(Qp, -1)[:Q]


def match_counts(q_sk, g_sk) -> jnp.ndarray:
    """Unblocked variant for small problems (compiles to one fused reduce).

    For large device-resident indexes use ops.bcount (the bit-plane count)
    — SketchIndex.counts routes automatically.
    """
    return jnp.sum((q_sk[:, None, :] == g_sk[None, :, :]),
                   axis=-1, dtype=jnp.int32)
