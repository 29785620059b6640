"""Talker: the Qwen3 decoder that emits codec-codebook-0 logits.

Thin wrapper over the shared decoder with the talker's M-RoPE position
convention (t = h = w = cache slot - pad offset, channel = 0;
`src/tts/engine.rs:306-314`). Consumes 2048-d *embedding* sequences built by
the prompt assembler — never token ids — matching the reference's
embeddings-only llama batches (`src/tts/engine.rs:456-462`).

Ragged prompt batches are LEFT-padded: row b's prompt occupies cache slots
[pad_offset[b], prompt_slots); RoPE positions are slot - pad_offset and pad
slots are masked out of attention via `kv_valid_from`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..core.config import TalkerConfig
from . import decoder


def prefill(
    params: decoder.DecoderParams,
    cfg: TalkerConfig,
    prompt_embeds: jax.Array,    # [B, S, H] left-padded prompt embeddings
    pad_offset: jax.Array,       # [B] number of left-pad slots per row
    cache: Dict[str, jax.Array],
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """Run the prompt through the talker. Returns (hidden of last position
    [B, H], logits at last position [B, vocab], cache)."""
    B, S, _ = prompt_embeds.shape
    slots = jnp.arange(S, dtype=jnp.int32)[None]             # [1, S]
    positions = jnp.maximum(slots - pad_offset[:, None], 0)  # [B, S]
    h, logits, cache = decoder.forward(
        params, cfg, prompt_embeds, positions, cache, jnp.int32(0),
        kv_valid_from=pad_offset,
    )
    return h[:, -1], logits[:, -1], cache


def step(
    params: decoder.DecoderParams,
    cfg: TalkerConfig,
    feedback: jax.Array,         # [B, H] frame-feedback embedding
    slot: jax.Array,             # scalar int32: cache slot to write
    pad_offset: jax.Array,       # [B]
    cache: Dict[str, jax.Array],
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """One autoregressive talker step. Returns (hidden [B,H], logits [B,vocab],
    cache)."""
    slot = jnp.asarray(slot, jnp.int32)
    positions = (slot - pad_offset)[:, None]                          # [B, 1]
    h, logits, cache = decoder.forward(
        params, cfg, feedback[:, None], positions, cache, slot,
        kv_valid_from=pad_offset,
    )
    return h[:, -1], logits[:, -1], cache
