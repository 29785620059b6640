"""The autoregressive generation loop (talker -> predictor -> feedback).

Re-design of `run_inference_stream` (`src/tts/engine.rs:445-656`).
The reference does, per ~83 ms frame of audio: 1 talker FFI decode, 16
predictor FFI decodes, a host matvec and 16 host table lookups — that
serialization is its RTF bottleneck (SURVEY.md §3.2). Here the entire frame —
talker step, code_0 sampling, predictor codebook scan, feedback embedding —
is ONE compiled program, and the whole utterance loop can additionally run
inside `lax.while_loop` so the host never syncs per frame (offline path).

Two entry points:
  * `generate_codes`    — fully fused device loop; returns the code matrix.
  * `make_stream_fns`   — jitted (prefill, frame_step) pair for streaming:
                          the host sees every frame's 16 codes as soon as the
                          step returns, feeding the vocoder pipeline with
                          4-frame chunks like the reference decoder thread.

EOS semantics preserved: generation stops when code_0 in {2150, 151673}; the
EOS frame itself is NOT emitted (`src/tts/engine.rs:558-561` breaks before
pushing codes).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..assets.tables import Assets
from ..core import protocol, sampling
from ..core.config import PredictorConfig, TalkerConfig
from ..models import decoder, predictor, talker

GenState = Dict[str, Any]


def _sample_code0(logits, key, temperature, top_k: int, top_p):
    """Talker code_0 from the [0, 2160) logit slice (src/tts/engine.rs:555)."""
    sliced = logits[..., : protocol.TALKER_SAMPLE_LIMIT]
    return sampling.sample(sliced, key, temperature, top_k, top_p)


def _is_eos(code0: jax.Array) -> jax.Array:
    eos = jnp.zeros_like(code0, dtype=bool)
    for e in protocol.TALKER_EOS_IDS:
        eos |= code0 == e
    return eos


def _feedback_embedding(assets: Assets, codes: jax.Array, hidden: int) -> jax.Array:
    """Sum of the 16 codec rows + tts_pad (src/tts/engine.rs:623-631).

    The reference then `resize`s to the talker width (truncate / zero-pad,
    src/tts/engine.rs:631) — a no-op in production where both are 2048.
    """
    fb = assets.frame_embedding_sum(codes) + assets.tts_pad
    dim = fb.shape[-1]
    if dim == hidden:
        return fb
    if dim > hidden:
        return fb[..., :hidden]
    pad = [(0, 0)] * (fb.ndim - 1) + [(0, hidden - dim)]
    return jnp.pad(fb, pad)


def _predict_codes(
    models: Dict[str, Any],
    pred_cfg: PredictorConfig,
    h1024: jax.Array,
    code0: jax.Array,
    draft: jax.Array | None = None,
) -> jax.Array:
    """Frame expansion: the autoregressive codebook scan, or the Jacobi
    expansion when QWEN3_TTS_PRED_JACOBI=1 (read at trace time)."""
    if os.environ.get("QWEN3_TTS_PRED_JACOBI") == "1" and draft is not None:
        # Jacobi self-speculative expansion (predictor.frame_codes_jacobi):
        # previous frame's codes as the draft; pass count tracks real-
        # weight temporal continuity.
        return predictor.frame_codes_jacobi(
            models["predictor"], pred_cfg, models["assets"], h1024, code0,
            draft)
    return predictor.frame_codes(
        models["predictor"], pred_cfg, models["assets"], h1024, code0
    )


def _frame_body(
    models: Dict[str, Any],
    talker_cfg: TalkerConfig,
    pred_cfg: PredictorConfig,
    top_k: int,
    state: GenState,
    ignore_eos: bool = False,
) -> Tuple[GenState, jax.Array, jax.Array]:
    """One frame: sample code_0 -> predictor expand -> feedback decode.

    Returns (new_state, frame_codes [B,16], newly_active [B] bool mask of rows
    that emitted a real frame this step).

    `ignore_eos` (benchmarking only): never stop on an EOS code_0, so every
    run covers exactly `max_steps` frames — with random weights EOS fires at
    random steps and "median ms/frame" would mix different program extents
    (VERDICT r3 #5). Production paths keep the reference EOS semantics.
    """
    key, sub = jax.random.split(state["key"])
    code0 = _sample_code0(
        state["logits"], sub, state["temperature"], top_k, state["top_p"]
    )
    eos = jnp.zeros_like(code0, dtype=bool) if ignore_eos else _is_eos(code0)
    # context cap (reference n_ctx, src/tts/engine.rs:133): a frame needs a
    # cache slot for its feedback token — rows whose next write position is
    # past the cache stop cleanly instead of clamp-corrupting the last slot.
    # `slot` is scalar (single/stream) or [B] (continuous batching); both
    # broadcast against done [B].
    cache_cap = state["cache"]["k"].shape[3]      # <= max_seq
    ctx_full = state["slot"] >= cache_cap
    done = state["done"] | eos | ctx_full
    active = ~done                                            # emits a frame

    h1024 = models["assets"].project(state["hidden"].astype(jnp.float32))
    codes = _predict_codes(models, pred_cfg, h1024, code0,
                           draft=state["prev_codes"])
    codes = jnp.where(active[:, None], codes, 0)

    fb = _feedback_embedding(models["assets"], codes, talker_cfg.hidden)
    # done rows keep being stepped (batch-shared program); clamping their
    # write position to the last slot only ever touches rows that are
    # already done, so live rows never see a corrupted cache.
    write_slot = jnp.minimum(state["slot"], cache_cap - 1)
    hidden, logits, cache = talker.step(
        models["talker"], talker_cfg, fb.astype(jnp.dtype(talker_cfg.dtype)),
        write_slot, state["pad_offset"], state["cache"],
    )

    new_state = dict(
        state,
        key=key,
        hidden=hidden,
        logits=logits,
        cache=cache,
        slot=jnp.minimum(state["slot"] + 1, cache_cap),
        step=state["step"] + 1,
        done=done,
        n_frames=state["n_frames"] + active.astype(jnp.int32),
        prev_codes=codes[:, 1:],
    )
    return new_state, codes, active


def cache_window(talker_cfg: TalkerConfig, prompt_len: int,
                 max_steps: int) -> int:
    """Talker KV extent for a bounded generation: prompt + frame budget,
    256-aligned, capped at max_seq. The default 4096-slot cache is 469
    MB/row on the flagship talker, and the dense decode attention reads the
    whole window, so sizing to the actual extent saves both memory and
    bandwidth."""
    need = prompt_len + max_steps + 1
    return min(talker_cfg.max_seq, -(-need // 256) * 256)


def init_state(
    models: Dict[str, Any],
    talker_cfg: TalkerConfig,
    prompt_embeds: jax.Array,      # [B, S, H] left-padded
    pad_offset: jax.Array,         # [B]
    key: jax.Array,
    temperature: float,
    top_p: float,
    cache_len: int | None = None,
) -> GenState:
    """Talker prefill -> initial generation state (src/tts/engine.rs:456-462)."""
    B, S, _ = prompt_embeds.shape
    cache = decoder.init_kv_cache(talker_cfg, B, length=cache_len)
    hidden, logits, cache = talker.prefill(
        models["talker"], talker_cfg,
        prompt_embeds.astype(jnp.dtype(talker_cfg.dtype)), pad_offset, cache,
    )
    return dict(
        key=key,
        hidden=hidden,
        logits=logits,
        cache=cache,
        slot=jnp.int32(S),
        step=jnp.int32(0),
        pad_offset=jnp.asarray(pad_offset, jnp.int32),
        done=jnp.zeros((B,), bool),
        n_frames=jnp.zeros((B,), jnp.int32),
        temperature=jnp.float32(temperature),
        top_p=jnp.float32(top_p),
        # previous frame's codebooks 1..15: the Jacobi draft
        prev_codes=jnp.zeros((B, protocol.NUM_CODEBOOKS - 1), jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "pred_cfg", "top_k", "max_steps", "ignore_eos"),
)
def generate_codes(
    models: Dict[str, Any],
    talker_cfg: TalkerConfig,
    pred_cfg: PredictorConfig,
    prompt_embeds: jax.Array,
    pad_offset: jax.Array,
    key: jax.Array,
    temperature: float,
    top_k: int,
    top_p: float,
    max_steps: int,
    ignore_eos: bool = False,
    step_cap: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Fused offline generation: whole loop on device.

    Returns (codes [B, max_steps, 16] int32 — rows zero-filled past each
    utterance's EOS — and n_frames [B] int32).

    `step_cap` (dynamic scalar <= max_steps) stops the loop early without
    changing the compiled extent: the engine buckets `max_steps` to a few
    static sizes and passes the exact per-request cap here, so distinct
    request lengths share one compiled program (ADVICE r4).
    """
    B = prompt_embeds.shape[0]
    cap = jnp.minimum(jnp.asarray(
        max_steps if step_cap is None else step_cap, jnp.int32), max_steps)
    state = init_state(
        models, talker_cfg, prompt_embeds, pad_offset, key, temperature,
        top_p,
        cache_len=cache_window(talker_cfg, prompt_embeds.shape[1], max_steps),
    )
    codes_buf = jnp.zeros((B, max_steps, protocol.NUM_CODEBOOKS), jnp.int32)

    def cond(carry):
        state, _ = carry
        return (state["step"] < cap) & ~jnp.all(state["done"])

    def body(carry):
        state, buf = carry
        step = state["step"]
        state, codes, active = _frame_body(
            models, talker_cfg, pred_cfg, top_k, state, ignore_eos,
        )
        buf = jax.lax.dynamic_update_slice(
            buf, codes[:, None], (jnp.int32(0), step, jnp.int32(0))
        )
        return state, buf

    state, codes_buf = jax.lax.while_loop(cond, body, (state, codes_buf))
    return codes_buf, state["n_frames"]


@functools.partial(
    jax.jit,
    static_argnames=(
        "talker_cfg", "pred_cfg", "voc_cfg", "top_k", "max_steps",
        "ignore_eos"),
)
def generate_audio(
    models: Dict[str, Any],
    voc_params: Dict[str, Any],
    talker_cfg: TalkerConfig,
    pred_cfg: PredictorConfig,
    voc_cfg,
    prompt_embeds: jax.Array,
    pad_offset: jax.Array,
    key: jax.Array,
    temperature: float,
    top_k: int,
    top_p: float,
    max_steps: int,
    ignore_eos: bool = False,
    step_cap: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Offline synthesis as ONE device program: the fused generation
    while_loop feeding the vocoder's one-shot decode, no host round-trip
    between them. `step_cap` buckets request lengths (see generate_codes).

    Returns (wav [B, (max_steps+lookahead)*frame_samples] f32, n_frames
    [B]); callers trim each row to n_frames * frame_samples. Rows past a
    row's EOS hold zero codes, which is exactly what the bucketed two-step
    path pads with — the vocoder is causal in frames, so the first
    n_frames of waveform are identical for any padded length (tested).
    """
    from ..models import vocoder

    codes, n_frames = generate_codes(
        models, talker_cfg, pred_cfg, prompt_embeds, pad_offset, key,
        temperature, top_k, top_p, max_steps, ignore_eos, step_cap,
    )
    B = codes.shape[0]
    # the one-shot extent is exactly max_steps frames: size the vocoder
    # KV to it (dense attention over max_frames=1024 slots costs ~3x the
    # vocoder's real work at 64-frame utterances)
    wav, _, _ = vocoder.decode(
        voc_params, voc_cfg, codes,
        vocoder.init_state(voc_cfg, B, frames=max_steps), True)
    return wav, n_frames


def make_stream_fns(talker_cfg: TalkerConfig, pred_cfg: PredictorConfig,
                    top_k: int, frames_per_call: int = 1,
                    cache_len: int | None = None):
    """Jitted (prefill_fn, step_fn) for streaming generation.

    step_fn advances `frames_per_call` frames per host round-trip (a scan), so
    a 4-frame vocoder chunk costs one dispatch. The host checks `done` and
    forwards emitted codes to the vocoder pipeline. `cache_len` bounds the
    talker KV window (serving memory budgets); None keeps cfg.max_seq.
    """

    @functools.partial(jax.jit, static_argnames=())
    def prefill_fn(models, prompt_embeds, pad_offset, key, temperature, top_p):
        return init_state(
            models, talker_cfg, prompt_embeds, pad_offset, key,
            temperature, top_p, cache_len=cache_len,
        )

    @jax.jit
    def step_fn(models, state):
        def one(state, _):
            state, codes, active = _frame_body(
                models, talker_cfg, pred_cfg, top_k, state
            )
            return state, (codes, active)

        state, (codes, active) = jax.lax.scan(
            one, state, None, length=frames_per_call
        )
        # codes: [frames_per_call, B, 16] -> [B, frames_per_call, 16]
        return state, jnp.swapaxes(codes, 0, 1), jnp.swapaxes(active, 0, 1)

    return prefill_fn, step_fn
