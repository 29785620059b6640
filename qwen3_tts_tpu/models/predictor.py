"""Predictor: per-frame autoregressive codebook expansion.

Replacement for the reference's 16 sequential llama.cpp FFI calls
per frame (`src/tts/engine.rs:564-611`): the KV clear, the 2-token prefill
`[proj(talker_hidden), codec_emb_1024(0, code_0)]`, and the 15 greedy
single-token decodes all live inside ONE compiled program — a `lax.scan` over
codebooks — so the host never syncs mid-frame (SURVEY.md §7 "hard parts").

Per-codebook sampling slices the 16x2048 output head: codebook q is always
greedy over `logits[(q-1)*2048 : q*2048]` minus the offset
(`src/tts/engine.rs:587-597`; predictor sampler is greedy,
`src/tts/engine.rs:470`).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ..assets.tables import Assets
from ..core import protocol
from ..core.config import PredictorConfig
from . import decoder


def frame_codes(
    params: decoder.DecoderParams,
    cfg: PredictorConfig,
    assets: Assets,
    talker_hidden_1024: jax.Array,   # [B, 1024] = assets.project(talker hidden)
    code_0: jax.Array,               # [B] int32 sampled by the talker
) -> jax.Array:
    """Expand code_0 into the full 16-code frame. Returns [B, 16] int32."""
    B = code_0.shape[0]
    cache = decoder.init_kv_cache(cfg, B)

    # --- prefill: [proj(m_hidden), codec_emb_1024(0, code_0)] at pos 0,1 ---
    c0_emb = assets.codec_embedding_1024(jnp.zeros_like(code_0), code_0)
    x = jnp.stack([talker_hidden_1024, c0_emb], axis=1)      # [B, 2, 1024]
    pos = jnp.broadcast_to(jnp.arange(2, dtype=jnp.int32)[None], (B, 2))
    h, _, cache = decoder.forward(
        params, cfg, x.astype(jnp.dtype(cfg.dtype)), pos, cache, jnp.int32(0),
        with_logits=False,
    )
    # only codebook-1's 2048-column head slice is needed from the prefill
    # (16x less head traffic than materialising all 32768 logits per step)
    row_logits = decoder.head_logits(
        params, h[:, -1], jnp.int32(0), protocol.CODE_VOCAB)  # [B, 2048]

    def step(carry, q):
        cache, row_logits = carry
        # greedy over head slice [(q-1)*2048, q*2048), offset removed
        code_q = jnp.argmax(row_logits, axis=-1).astype(jnp.int32)
        # feed codec_emb_1024(q, code_q) at position q+1. The reference skips
        # the decode after q=15; running it uniformly inside scan is free of
        # host syncs and its output is simply unused.
        emb = assets.codec_embedding_1024(jnp.full_like(code_q, q), code_q)
        pos = jnp.broadcast_to((q + 1)[None, None], (B, 1))
        h, _, cache = decoder.forward(
            params, cfg, emb[:, None].astype(jnp.dtype(cfg.dtype)), pos,
            cache, q + 1, with_logits=False,
        )
        row_logits = decoder.head_logits(
            params, h[:, -1], q * protocol.CODE_VOCAB, protocol.CODE_VOCAB)
        return (cache, row_logits), code_q

    qs = jnp.arange(1, protocol.NUM_CODEBOOKS, dtype=jnp.int32)
    # codes come back as stacked scan outputs — no per-step scatter
    (cache, _), codes_rest = jax.lax.scan(step, (cache, row_logits), qs)
    return jnp.concatenate(
        [code_0[:, None], jnp.moveaxis(codes_rest, 0, 1)], axis=1)


def teacher_forced_logits(
    params: decoder.DecoderParams,
    cfg: PredictorConfig,
    assets: Assets,
    talker_hidden_1024: jax.Array,   # [B, 1024]
    codes: jax.Array,                # [B, 16] int32 (code_0 + 15 inputs)
) -> jax.Array:
    """Codebook-q logits for q=1..15 given the frame's codes as inputs:
    one parallel pass over [h1024, emb(0,c_0), .., emb(14,c_14)]. Returns
    float32 [B, 15, 2048]; the argmax at q equals frame_codes' code q when
    codes[:, 1:q] are frame_codes' own codes."""
    B = codes.shape[0]
    NB = protocol.NUM_CODEBOOKS
    CV = protocol.CODE_VOCAB
    q_idx = jnp.arange(NB - 1, dtype=jnp.int32)               # 0..14
    pos = jnp.broadcast_to(jnp.arange(NB, dtype=jnp.int32)[None], (B, NB))
    # emb(15, *) feeds nothing we read
    embs = assets.codec_embedding_1024(q_idx[None], codes[:, : NB - 1])
    x = jnp.concatenate([talker_hidden_1024[:, None], embs], axis=1)
    cache = decoder.init_kv_cache(cfg, B, length=NB)
    h, _, _ = decoder.forward(
        params, cfg, x.astype(jnp.dtype(cfg.dtype)), pos, cache,
        jnp.int32(0), with_logits=False)
    # static loop: 15 head column slices
    return jnp.stack(
        [decoder.head_logits(params, h[:, q], jnp.int32((q - 1) * CV), CV)
         for q in range(1, NB)], axis=1)


def frame_codes_jacobi(
    params: decoder.DecoderParams,
    cfg: PredictorConfig,
    assets: Assets,
    talker_hidden_1024: jax.Array,   # [B, 1024]
    code_0: jax.Array,               # [B] int32
    draft: jax.Array | None = None,  # [B, 15] int32 initial guesses
) -> jax.Array:
    """Jacobi / self-speculative frame expansion: EXACT greedy codes
    (bit-identical to frame_codes by construction), in as few parallel
    passes as the draft quality allows.

    The AR chain `c_q = argmax(head_q(h(positions<=q)))` is a fixed point
    of the parallel map "forward ALL 16 positions at once, read every
    codebook's argmax". One pass over the sequence [h1024, emb(0,c_0),
    emb(1,d_1), ..., emb(14,d_14)] yields pred_q for q=1..15; pred_q is
    the TRUE code for every q up to and including the first draft
    mismatch (its inputs were all correct), so each pass verifies a
    prefix AND proposes the next draft — at least one new code is fixed
    per pass, and a perfect draft finishes in ONE pass of 8 layer-passes
    instead of the AR loop's 136. The predictor is weight-streaming-bound
    at B=1, so a 16-token pass costs about the same HBM traffic as one
    AR micro-step.

    The natural draft in the generation loop is the PREVIOUS frame's
    codes (speech codecs are temporally continuous); acceptance — and
    hence the speedup — is a property of real weights, so the loop keeps
    the AR scan by default (QWEN3_TTS_PRED_JACOBI=1 opts in).

    Technique family: Jacobi / parallel decoding of AR chains, as applied
    to codec-token speech synthesis in the retrieved literature
    (PAPERS.md: Llasa+ "free lunch" acceleration, speculative AR speech
    synthesis, FlashTTS MTP) — re-derived here for the 16-codebook
    predictor protocol with exact-greedy verification.
    """
    B = code_0.shape[0]
    NB = protocol.NUM_CODEBOOKS
    if draft is None:
        draft = jnp.zeros((B, NB - 1), jnp.int32)
    codes0 = jnp.concatenate([code_0[:, None],
                              jnp.asarray(draft, jnp.int32)], axis=1)

    def one_pass(codes):
        return jnp.argmax(teacher_forced_logits(
            params, cfg, assets, talker_hidden_1024, codes),
            axis=-1).astype(jnp.int32)                        # [B, 15]

    def cond(carry):
        codes, verified, it = carry
        return (it < NB - 1) & jnp.any(verified < NB)

    def body(carry):
        codes, verified, it = carry
        preds = one_pass(codes)
        # pred_q true for q <= first mismatch vs the current draft
        mism = preds != codes[:, 1:]                          # [B, 15]
        qpos = jnp.arange(1, NB, dtype=jnp.int32)[None]
        first_mism = jnp.min(jnp.where(mism, qpos, NB), axis=1)  # [B]
        # pred at the first mismatching position is itself TRUE (computed
        # under a fully-correct prefix), so indices <= first_mism are now
        # known — and a frontier at the last index means the row is done
        new_verified = jnp.maximum(
            verified, jnp.where(first_mism >= NB - 1, NB, first_mism))
        # verified codes freeze; the rest take this pass's preds as the
        # next draft (rows already fully verified keep their codes)
        keep = qpos <= verified[:, None]
        new_rest = jnp.where(keep, codes[:, 1:], preds)
        new_codes = jnp.concatenate([codes[:, :1], new_rest], axis=1)
        return new_codes, new_verified, it + 1

    # verified[b] = largest code index known true; only c_0 at the start
    codes, _, _ = jax.lax.while_loop(
        cond, body, (codes0, jnp.zeros((B,), jnp.int32), jnp.int32(0)))
    return codes
