"""Attention ops: GQA prefill + KV-cache decode.

Reference behavior being replaced: llama.cpp flash attention over its own KV
cache (`src/models/llama/mod.rs:415` flash_attn_type=1). Here the cache is a
preallocated device buffer `[n_layers, B, n_kv_heads, max_seq, head_dim]`
updated with `lax.dynamic_update_slice`, and attention is computed with
length-masked dense math that XLA fuses. The same function serves prefill
and single-token decode on every backend.

All math accumulates in float32 regardless of the cache/activation dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def _per_row(start: jax.Array, batch: int) -> jax.Array:
    """Normalise a scalar-or-[B] cache position to [B] int32. Per-row
    positions are what continuous batching needs: co-batched streams admitted
    at different times each write/read their own cache extent."""
    start = jnp.asarray(start, jnp.int32)
    if start.ndim == 0:
        start = jnp.broadcast_to(start, (batch,))
    return start


def update_kv_cache(
    k_cache: jax.Array,   # [B, nk, T, hd] (head-major)
    v_cache: jax.Array,
    k_new: jax.Array,     # [B, S, nk, hd]
    v_new: jax.Array,
    start: jax.Array,     # scalar or [B] int32: per-row write offset
):
    starts = _per_row(start, k_cache.shape[0])

    def write(cache, new):
        new_t = jnp.swapaxes(new, 1, 2)                 # [B, nk, S, hd]
        return jax.vmap(
            lambda c, n, s: jax.lax.dynamic_update_slice(
                c, n.astype(c.dtype), (jnp.int32(0), s, jnp.int32(0)))
        )(cache, new_t, starts)

    return write(k_cache, k_new), write(v_cache, v_new)


def gqa_attention(
    q: jax.Array,          # [B, S, nq, hd]
    k: jax.Array,          # [B, nk, T, hd] (full cache buffer, head-major)
    v: jax.Array,          # [B, nk, T, hd]
    q_start: jax.Array,    # scalar or [B]: cache slot of query 0 per row
    kv_len: jax.Array,     # scalar or [B]: valid cache entries (incl. new)
    kv_valid_from: jax.Array | None = None,   # [B]: first valid cache slot
) -> jax.Array:
    """Causal masked attention of new queries against the cache buffer.

    Query i of row b (cache slot q_start[b] + i) attends cache slots j with
    kv_valid_from[b] <= j <= q_start[b] + i and j < kv_len[b]. Per-row
    positions support left-padded ragged prompts AND continuous batching
    (streams admitted at different times). Returns [B, S, nq, hd] in q.dtype.
    """
    B, S, nq, hd = q.shape
    nk = k.shape[1]
    T = k.shape[2]
    g = nq // nk

    qf = q.astype(jnp.float32).reshape(B, S, nk, g, hd)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)

    scores = jnp.einsum("bskgh,bkth->bkgst", qf, kf) / jnp.sqrt(float(hd))

    t_idx = jnp.arange(T, dtype=jnp.int32)
    s_idx = jnp.arange(S, dtype=jnp.int32)
    q_pos = _per_row(q_start, B)[:, None] + s_idx[None, :]   # [B, S]
    kv_len_b = _per_row(kv_len, B)                           # [B]
    mask = (t_idx[None, None, :] <= q_pos[:, :, None]) & (
        t_idx[None, None, :] < kv_len_b[:, None, None]
    )                                                        # [B, S, T]
    if kv_valid_from is not None:
        valid = t_idx[None, :] >= jnp.asarray(kv_valid_from, jnp.int32)[:, None]
        mask = mask & valid[:, None, :]
    scores = jnp.where(mask[:, None, None], scores, NEG_INF)

    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bkgst,bkth->bskgh", probs, vf)
    return out.reshape(B, S, nq, hd).astype(q.dtype)
