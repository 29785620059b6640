#!/usr/bin/env python
"""Benchmark: single-stream RTF and batched throughput on one GPU.

Times the engine's offline path as ONE device program
(generate.generate_audio: the `lax.while_loop` running the whole utterance —
talker step + 16-code predictor expansion per frame — feeding the vocoder's
one-shot decode, no host round-trip between codes and waveform), on the
full-size flagship config with seeded random weights (reference weights are
not redistributable; FLOP/byte volumes and code paths are identical — only
argmax values differ). The headline frame_ms therefore INCLUDES vocoding.

Measured, all on the plain XLA path:
  * single-stream ms/frame with talker int4 + predictor int8 (headline),
    int8 everywhere, and bf16;
  * batched ms/frame-step and audio-s/s at B = 8, 16, 32 (headline quant);
  * first-chunk latency (prefill + 4 frames + 4-frame vocode, wall clock);
  * vocoder one-shot decode ms/frame.
The vocoder trunk runs in bf16 (vocoder.with_dtype) with f32 conv stacks.

Timing is EOS-masked (`ignore_eos=True`): with random weights and sampling,
EOS fires at random steps, so unmasked "median ms/frame" mixes different
program extents. Every timed dispatch covers exactly N_STEPS frames;
production EOS semantics are untouched (tests/test_generate.py). Each
measurement compiles and warms up first, then takes the median of its timed
runs; seeds are fixed.

Refuses any device but a GPU. Any failure exits non-zero. Prints ONE JSON
line on stdout:
  {"metric": "rtf_per_stream", "value": N, "unit": "s_compute/s_audio",
   "vs_baseline": N, "detail": {...}}
vs_baseline = 0.553 / value (x-times faster than the reference's best CUDA
RTF on an RTX 2080 Ti, BASELINE.md).
"""

import dataclasses
import json
import sys
import time

N_STEPS = 64          # frames per timed generation (~5.3 s of audio)
PROMPT_SLOTS = 64
TIMED_RUNS = 5


def _median_s(fn, runs: int = TIMED_RUNS) -> float:
    """Compile + one warm run, then the median wall time of `runs` calls;
    `fn` must block until its result is on the host."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def main() -> int:
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.assets import tables
    from qwen3_tts_tpu.core import protocol as P
    from qwen3_tts_tpu.core.config import EngineConfig
    from qwen3_tts_tpu.models import decoder, vocoder
    from qwen3_tts_tpu.ops import quant
    from qwen3_tts_tpu.tts import generate
    from qwen3_tts_tpu.utils import profiling

    device = profiling.device_record()
    if device["platform"] != "gpu":
        print(f"bench: needs a GPU, JAX found {device}", file=sys.stderr)
        return 2
    card = profiling.card_info()
    print(f"card: {card}; {device}", file=sys.stderr)

    cfg = EngineConfig()
    k = jax.random.split(jax.random.key(0), 4)
    dense = {
        "talker": decoder.init_decoder(k[0], cfg.talker),
        "predictor": decoder.init_decoder(k[1], cfg.predictor),
        "assets": tables.random_assets(
            k[2], text_vocab=P.TEXT_VOCAB, codec_rows=3072,
            dim=cfg.talker.hidden, proj_dim=cfg.predictor.hidden,
        ),
    }
    voc_cfg = dataclasses.replace(cfg.vocoder, dtype="bfloat16")
    voc_params = vocoder.with_dtype(
        vocoder.init_vocoder(k[3], cfg.vocoder), voc_cfg)
    jax.block_until_ready(dense)

    def models(talker_kind, predictor_kind):
        def q(params, kind):
            return params if kind == "bf16" else \
                quant.quantize_decoder_params(params, kind=kind)
        m = dict(dense, talker=q(dense["talker"], talker_kind),
                 predictor=q(dense["predictor"], predictor_kind))
        jax.block_until_ready(m)
        return m

    def frame_ms(mdl, batch: int, tag: str) -> float:
        prompt = 0.1 * jax.random.normal(
            jax.random.key(9), (batch, PROMPT_SLOTS, cfg.talker.hidden),
            jnp.bfloat16)
        pad = jnp.zeros((batch,), jnp.int32)

        def run():
            wav, n_frames = generate.generate_audio(
                mdl, voc_params, cfg.talker, cfg.predictor, voc_cfg,
                prompt, pad, jax.random.key(1), 0.7, 40, 0.9, N_STEPS,
                ignore_eos=True)
            n = jax.device_get(n_frames)
            if not (n == N_STEPS).all():      # EOS mask: fixed extent
                raise RuntimeError(f"expected {N_STEPS} frames, got {n}")

        ms = 1e3 * _median_s(run) / N_STEPS
        print(f"[{tag}] B={batch}: {ms:.3f} ms/frame-step", file=sys.stderr)
        return ms

    def first_chunk_ms(mdl) -> float:
        prefill_fn, step_fn = generate.make_stream_fns(
            cfg.talker, cfg.predictor, 40,
            frames_per_call=P.STREAM_CHUNK_FRAMES)
        prompt = 0.1 * jax.random.normal(
            jax.random.key(9), (1, PROMPT_SLOTS, cfg.talker.hidden),
            jnp.bfloat16)
        pad = jnp.zeros((1,), jnp.int32)

        def run():
            st = prefill_fn(mdl, prompt, pad, jax.random.key(2), 0.7, 0.9)
            st, codes, _ = step_fn(mdl, st)
            wav, _, _ = vocoder.decode(voc_params, voc_cfg, codes,
                                       vocoder.init_state(voc_cfg, 1), False)
            jax.device_get(wav)                # audio is deliverable

        return 1e3 * _median_s(run)

    def vocoder_frame_ms() -> float:
        codes = jax.random.randint(jax.random.key(3), (1, N_STEPS, 16), 0,
                                   P.CODE_VOCAB, jnp.int32)

        def run():
            wav, _, _ = vocoder.decode(voc_params, voc_cfg, codes,
                                       vocoder.init_state(voc_cfg, 1), True)
            jax.device_get(jnp.sum(wav))

        return 1e3 * _median_s(run) / N_STEPS

    frame_audio_s = P.FRAME_SAMPLES / P.SAMPLE_RATE      # 1/12 s
    headline = models("int4", "int8")
    single = {"int4+int8": frame_ms(headline, 1, "int4+int8")}
    batched = {}
    for b in (8, 16, 32):
        ms = frame_ms(headline, b, "int4+int8")
        batched[f"b{b}"] = {"frame_step_ms": round(ms, 3),
                            "audio_s_per_s": round(b * frame_audio_s * 1e3 / ms,
                                                   2)}
    first_chunk = first_chunk_ms(headline)
    del headline
    single["int8"] = frame_ms(models("int8", "int8"), 1, "int8")
    single["bf16"] = frame_ms(dense, 1, "bf16")
    voc_ms = vocoder_frame_ms()

    rtf = single["int4+int8"] / 1e3 / frame_audio_s
    print(json.dumps({
        "metric": "rtf_per_stream",
        "value": round(rtf, 4),
        "unit": "s_compute/s_audio",
        "vs_baseline": round(0.553 / rtf, 2),
        "detail": {
            "quant": "int4+int8",
            "frame_ms": {k: round(v, 3) for k, v in single.items()},
            "audio_seconds_per_s_per_card_b1": round(1 / rtf, 2),
            "batched": batched,
            "first_chunk_ms": round(first_chunk, 1),
            "vocoder_frame_ms": round(voc_ms, 3),
            "vocoder_dtype": voc_cfg.dtype,
            "n_steps": N_STEPS,
            "eos_masked_timing": True,
            "device": device,
            "card": card,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
