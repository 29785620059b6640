"""Qwen3-style decoder shared by the talker and the predictor.

Replacement for the two GGUF transformers the reference runs
inside llama.cpp (`src/models/llama/mod.rs`): embedding *inputs* (never token
ids), RMSNorm + QK-norm, GQA with M-RoPE, SwiGLU MLP, final norm + dense head.
Layer weights are stacked on a leading axis and executed with `lax.scan`, so
the whole decode step is one compiled program regardless of depth.

Decode-step design choices:
  * QKV and gate/up projections are FUSED single matmuls (`wqkv`, `w_gu`) —
    half the op count per layer;
  * the stacked KV cache [L, B, n_kv, T, hd] is a scan CARRY updated in
    place at (layer, row, slot) — no per-layer cache copies;
  * `head_slice` computes only a dynamic column slice of the output head
    (the predictor samples 2048 of 32768 logits per step: 16x less head
    traffic, src/tts/engine.rs:587-597).

Weight pytree layout (all [L, ...] stacked):
  layers/ln1 [L,H], wqkv [L,H,(nq+2nk)*hd], q_norm [L,hd], k_norm [L,hd],
  wo [L,nq*hd,H], ln2 [L,H], w_gu [L,H,2F], w_down [L,F,H]
  final_norm [H], head [H, vocab]

The KV cache is {"k","v": [L, B, n_kv, T, hd]} plus an external scalar-or-[B]
`cache_len` (tokens already written, per row for continuous batching).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..core.config import PredictorConfig, TalkerConfig
from ..ops import attention, rope
from ..ops.quant import linear

DecoderParams = Dict[str, Any]
Config = TalkerConfig | PredictorConfig


def rms_norm(x: jax.Array, scale: jax.Array, eps: float) -> jax.Array:
    # single-rounding form: all f32 math, ONE cast to the model dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)
            * scale.astype(jnp.float32)).astype(x.dtype)


def init_decoder(key: jax.Array, cfg: Config, scale: float = 0.02) -> DecoderParams:
    L, H, F = cfg.n_layers, cfg.hidden, cfg.ffn_dim
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = jnp.dtype(cfg.dtype)
    ks = jax.random.split(key, 8)

    def w(k, shape):
        return (scale * jax.random.normal(k, shape)).astype(dtype)

    return {
        "layers": {
            "ln1": jnp.ones((L, H), dtype),
            "wqkv": w(ks[0], (L, H, (nq + 2 * nk) * hd)),
            "q_norm": jnp.ones((L, hd), dtype),
            "k_norm": jnp.ones((L, hd), dtype),
            "wo": w(ks[3], (L, nq * hd, H)),
            "ln2": jnp.ones((L, H), dtype),
            "w_gu": w(ks[4], (L, H, 2 * F)),
            "w_down": w(ks[6], (L, F, H)),
        },
        "final_norm": jnp.ones((H,), dtype),
        "head": w(ks[7], (H, cfg.vocab)),
    }


def init_kv_cache(cfg: Config, batch: int, dtype=None,
                  length: int | None = None) -> Dict[str, jax.Array]:
    """Head-major layout [L, B, n_kv, T, hd]: per-head cache slices are
    contiguous.

    `length` overrides cfg.max_seq — generation paths size the cache to
    the actual prompt+budget extent (a decode stream needs nowhere near
    4096 live slots), which is what lets B=32 talker batches fit HBM.
    """
    dtype = dtype or jnp.dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads,
             length or cfg.max_seq, cfg.head_dim)
    return {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}


def _write_layer_cache(cache_all: jax.Array, new: jax.Array, layer: jax.Array,
                       start: jax.Array) -> jax.Array:
    """In-place token write into the stacked cache.

    cache_all [L, B, nk, T, hd]; new [B, S, nk, hd] written at
    (layer, b, :, start[b]:start[b]+S, :). A scalar `start` (all rows at the
    same position — the normal generation loop) takes one
    dynamic_update_slice; per-row starts (continuous batching) go through a
    vmapped write, which lowers to a scatter.
    """
    new_t = jnp.swapaxes(new, 1, 2)                      # [B, nk, S, hd]
    start = jnp.asarray(start, jnp.int32)
    if start.ndim == 0:
        zero = jnp.int32(0)
        return jax.lax.dynamic_update_slice(
            cache_all, new_t[None].astype(cache_all.dtype),
            (layer, zero, zero, start, zero))

    def one(cab, nb, s):                                 # cab [L, nk, T, hd]
        return jax.lax.dynamic_update_slice(
            cab, nb[None].astype(cab.dtype),
            (layer, jnp.int32(0), s, jnp.int32(0)))

    return jax.vmap(one, in_axes=(1, 0, 0), out_axes=1)(cache_all, new_t, start)


def head_logits(params: DecoderParams, h: jax.Array,
                start: jax.Array, width: int) -> jax.Array:
    """Logits for a dynamic column slice [start, start+width) of the head.

    Supports dense and int8-quantized heads; returns float32 [..., width].
    """
    head = params["head"]
    if isinstance(head, dict) and "q" in head:
        q = jax.lax.dynamic_slice_in_dim(head["q"], start, width, axis=1)
        s = jax.lax.dynamic_slice_in_dim(head["scale"], start, width, axis=0)
        return linear(h, {"q": q, "scale": s}).astype(jnp.float32)
    if isinstance(head, dict) and "q4" in head:
        # nibble packing pairs ROWS; column slices are packing-transparent
        q4 = jax.lax.dynamic_slice_in_dim(head["q4"], start, width, axis=1)
        m8 = jax.lax.dynamic_slice_in_dim(head["m8"], start, width, axis=1)
        s = jax.lax.dynamic_slice_in_dim(head["scale"], start, width, axis=0)
        return linear(h, {"q4": q4, "m8": m8, "scale": s}).astype(jnp.float32)
    w = jax.lax.dynamic_slice_in_dim(head, start, width, axis=1)
    return (h @ w).astype(jnp.float32)


def forward(
    params: DecoderParams,
    cfg: Config,
    x: jax.Array,              # [B, S, H] embedding inputs
    positions: jax.Array,      # [B, S] sequence positions
    cache: Dict[str, jax.Array],
    cache_len: jax.Array,      # scalar or [B] int32: tokens already in cache
    *,
    kv_valid_from: jax.Array | None = None,  # [B] first valid cache slot
    with_logits: bool = True,
) -> Tuple[jax.Array, jax.Array | None, Dict[str, jax.Array]]:
    """Run S new tokens through the decoder.

    Returns (hidden [B,S,H], logits [B,S,vocab] or None, updated cache).
    """
    B, S, H = x.shape
    nq, nk, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    cache_len = jnp.asarray(cache_len, jnp.int32)
    kv_len = cache_len + S

    pos4 = rope.mrope_positions(positions)
    cos, sin = rope.rope_angles(pos4, cfg.mrope_sections, hd, cfg.rope_theta)

    def layer_step(carry, inputs):
        h, k_all, v_all = carry
        lw, layer_idx = inputs
        # --- attention block ---
        a_in = rms_norm(h, lw["ln1"], cfg.rms_eps)
        qkv = linear(a_in, lw["wqkv"])
        ni = getattr(cfg, "tp_interleave", 1)
        if ni > 1:
            # TP layout (parallel/sharding.interleave_wqkv): columns come in
            # `ni` device blocks [q_d | k_d | v_d], so this split is a pure
            # shard-local reshape — no GSPMD resharding. Each block's heads
            # are the original contiguous range, so the flattened head order
            # (and the GQA q->kv grouping) is unchanged.
            nqm, nkm = nq // ni, nk // ni
            qkv4 = qkv.reshape(B, S, ni, (nqm + 2 * nkm) * hd)
            q = qkv4[..., : nqm * hd].reshape(B, S, nq, hd)
            k = qkv4[..., nqm * hd: (nqm + nkm) * hd].reshape(B, S, nk, hd)
            v = qkv4[..., (nqm + nkm) * hd:].reshape(B, S, nk, hd)
        else:
            q = qkv[..., : nq * hd].reshape(B, S, nq, hd)
            k = qkv[..., nq * hd: (nq + nk) * hd].reshape(B, S, nk, hd)
            v = qkv[..., (nq + nk) * hd:].reshape(B, S, nk, hd)
        q = rms_norm(q, lw["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lw["k_norm"], cfg.rms_eps)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
        k_all = _write_layer_cache(k_all, k, layer_idx, cache_len)
        v_all = _write_layer_cache(v_all, v, layer_idx, cache_len)
        k_cache = jax.lax.dynamic_index_in_dim(k_all, layer_idx, 0,
                                               keepdims=False)
        v_cache = jax.lax.dynamic_index_in_dim(v_all, layer_idx, 0,
                                               keepdims=False)
        attn = attention.gqa_attention(
            q, k_cache, v_cache, cache_len, kv_len, kv_valid_from
        )
        h = h + linear(attn.reshape(B, S, nq * hd), lw["wo"])
        # --- MLP block (SwiGLU, fused gate+up) ---
        m_in = rms_norm(h, lw["ln2"], cfg.rms_eps)
        gu = linear(m_in, lw["w_gu"])
        F = gu.shape[-1] // 2
        # silu in f32 with a SINGLE rounding to the model dtype: jax.nn.silu
        # on bf16 rounds the sigmoid and the product separately
        gu32 = gu.astype(jnp.float32)
        act = (gu32[..., :F] / (1.0 + jnp.exp(-gu32[..., :F]))
               * gu32[..., F:]).astype(gu.dtype)
        h = h + linear(act, lw["w_down"])
        return (h, k_all, v_all), None

    layer_ids = jnp.arange(cfg.n_layers, dtype=jnp.int32)
    unroll = max(1, min(getattr(cfg, "scan_unroll", 1), cfg.n_layers))
    (h, new_k, new_v), _ = jax.lax.scan(
        layer_step,
        (x.astype(jnp.dtype(cfg.dtype)), cache["k"], cache["v"]),
        (params["layers"], layer_ids),
        unroll=unroll,
    )
    new_cache = {"k": new_k, "v": new_v}

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = None
    if with_logits:
        logits = linear(h, params["head"]).astype(jnp.float32)
    return h, logits, new_cache
