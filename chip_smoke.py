#!/usr/bin/env python
"""Smoke run of the whole system on one GPU.

One process holds the card and runs, at the widths of the configuration
(`EngineConfig()` by default: talker 2048 x 28 layers, predictor 1024 x 8
layers, vocoder) with seeded random weights:

  * correctness checks against a float32 reference run under
    `jax.default_matmul_precision("highest")` (a float32 product may
    otherwise run as TF32 on the card):
      - talker logits after a 64-slot prefill and 8 cached decode steps,
        bf16 against float32, and the float32 cached decode against one
        float32 forward over the whole sequence;
      - predictor frame logits, bf16 against float32 (logits, not codes:
        random weights give near ties);
      - `quant.linear` with int8 and int4 weights at the talker's wqkv,
        w_gu and w_down shapes, against dequantize + float32;
      - vocoder chunked decode against one-shot decode;
      - a negative check: the bf16 talker output must fail the float32
        tolerance, which shows the reference ran at full precision;
  * the main path through the user's entry points: one
    `TtsEngine.generate_with_voice` with a preset speaker, one
    `generate_stream`, and the HTTP server answering 3 concurrent
    `POST /tts` requests (one streamed) with 4 stream slots.

Each phase is a function of an EngineConfig, so the tests run the same
functions at `tiny_engine_config()` on the CPU. `main()` refuses any device
but a GPU.

Usage:  python chip_smoke.py
The last line of stdout is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
and is printed only when every phase passed.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from qwen3_tts_tpu import SamplerConfig, TtsEngine
from qwen3_tts_tpu import server as server_mod
from qwen3_tts_tpu.assets import tables
from qwen3_tts_tpu.core import protocol as P
from qwen3_tts_tpu.core.config import EngineConfig
from qwen3_tts_tpu.models import decoder, predictor, vocoder
from qwen3_tts_tpu.ops import quant
from qwen3_tts_tpu.utils import profiling

SPEAKERS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "speakers")

# Tolerances on the relative error ||a - ref|| / ||ref||, with their reasons.
TOL_F32 = (1e-4, "float32 on both sides under 'highest': only the order "
                 "of summation differs")
TOL_BF16 = (5e-2, "bf16 keeps 8 mantissa bits and rounds the activations "
                  "at every layer of the stack")
TOL_QUANT = (1e-2, "same quantized weights on both sides; the bf16 output "
                   "of linear rounds at 2^-9, and int4's nib*m8 rounds once "
                   "through bf16")
TOL_VOCODER = (1e-2, "the float32 trunk runs at default precision (TF32 on "
                     "the card, 10 mantissa bits), and chunked and one-shot "
                     "decode run GEMMs of different shapes")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    tol: float
    reason: str
    precision: str
    negative: bool = False      # passes when value EXCEEDS tol

    @property
    def ok(self) -> bool:
        if not np.isfinite(self.value):
            return False
        return self.value > self.tol if self.negative else self.value <= self.tol

    def line(self) -> str:
        rel = ">" if self.negative else "<="
        return (f"check {self.name}: rel_err={self.value:.3e} must be "
                f"{rel} {self.tol:.0e} [{self.precision}; {self.reason}] "
                f"-> {'PASS' if self.ok else 'FAIL'}")


def rel_err(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


def _to_f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _assets(cfg: EngineConfig, key):
    """Random tables shaped like the engine's own (tts.engine.TtsEngine)."""
    full = cfg.talker.hidden >= 2048
    return tables.random_assets(
        key, text_vocab=P.TEXT_VOCAB if full else 1024,
        codec_rows=3072 if full else 2176, dim=cfg.talker.hidden,
        proj_dim=cfg.predictor.hidden)


_forward = jax.jit(decoder.forward, static_argnums=(1,),
                   static_argnames=("with_logits",))


def _cached_logits(params, cfg, x, n_prefill: int, window: int):
    """Logits at the last prefill slot and at each following cached
    single-token decode step: [B, 1 + steps, vocab]."""
    B, S, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    cache = decoder.init_kv_cache(cfg, B, length=window)
    _, lg, cache = _forward(params, cfg, x[:, :n_prefill],
                            pos[:, :n_prefill], cache, jnp.int32(0))
    out = [lg[:, -1]]
    for t in range(n_prefill, S):
        _, lg, cache = _forward(params, cfg, x[:, t:t + 1], pos[:, t:t + 1],
                                cache, jnp.int32(t))
        out.append(lg[:, -1])
    return jnp.stack(out, axis=1)


def check_talker(cfg: EngineConfig, seed: int = 0, prefill: int = 64,
                 steps: int = 8) -> List[Check]:
    lo = dataclasses.replace(cfg.talker, dtype="bfloat16")
    hi = dataclasses.replace(cfg.talker, dtype="float32")
    params = decoder.init_decoder(jax.random.key(seed), lo)
    params32 = _to_f32(params)
    S = prefill + steps
    window = -(-S // 128) * 128
    x = jax.random.normal(jax.random.key(seed + 1), (1, S, lo.hidden))
    got = _cached_logits(params, lo, x.astype(jnp.bfloat16), prefill, window)
    with jax.default_matmul_precision("highest"):
        ref = _cached_logits(params32, hi, x, prefill, window)
        pos = jnp.arange(S, dtype=jnp.int32)[None]
        _, full, _ = _forward(params32, hi, x, pos,
                              decoder.init_kv_cache(hi, 1, length=window),
                              jnp.int32(0))
    full = full[:, prefill - 1:]
    e_lo = rel_err(got, ref)
    tag = f"{prefill}-slot prefill + {steps} decode steps"
    return [
        Check(f"talker logits bf16 vs f32 ({tag})", e_lo, *TOL_BF16,
              precision="bf16 default vs f32 highest"),
        Check(f"talker logits f32 cached decode vs f32 full forward ({tag})",
              rel_err(ref, full), *TOL_F32, precision="f32 highest"),
        Check("negative: talker bf16 logits vs the f32 tolerance", e_lo,
              TOL_F32[0], "a bf16 result must not pass as float32",
              precision="bf16 default vs f32 highest", negative=True),
    ]


def check_predictor(cfg: EngineConfig, seed: int = 0,
                    batch: int = 2) -> List[Check]:
    lo = dataclasses.replace(cfg.predictor, dtype="bfloat16")
    hi = dataclasses.replace(cfg.predictor, dtype="float32")
    k = jax.random.split(jax.random.key(seed), 4)
    params = decoder.init_decoder(k[0], lo)
    params32 = _to_f32(params)
    assets = _assets(cfg, k[1])
    h = jax.random.normal(k[2], (batch, cfg.predictor.hidden))
    code0 = jax.random.randint(k[3], (batch,), 0, P.CODE_VOCAB, jnp.int32)
    frame_codes = jax.jit(predictor.frame_codes, static_argnums=(1,))
    logits = jax.jit(predictor.teacher_forced_logits, static_argnums=(1,))
    with jax.default_matmul_precision("highest"):
        codes = frame_codes(params32, hi, assets, h, code0)
        ref = logits(params32, hi, assets, h, codes)
    got = logits(params, lo, assets, h, codes)
    # the cached scan's codes must be argmaxes of the one-pass f32 logits
    ref_np = np.asarray(ref)
    picked = np.take_along_axis(ref_np, np.asarray(codes)[:, 1:, None], -1)
    gap = float(np.max(ref_np.max(-1) - picked[..., 0])
                / np.sqrt(np.mean(ref_np ** 2)))
    return [
        Check("predictor frame logits bf16 vs f32 (teacher-forced)",
              rel_err(got, ref), *TOL_BF16,
              precision="bf16 default vs f32 highest"),
        Check("predictor f32 scan codes vs argmax of one f32 pass "
              "(logit gap / logit rms)", gap, *TOL_F32,
              precision="f32 highest"),
    ]


def check_quant(cfg: EngineConfig, seed: int = 0, rows: int = 8) -> List[Check]:
    t = cfg.talker
    shapes = {
        "wqkv": (t.hidden, (t.n_q_heads + 2 * t.n_kv_heads) * t.head_dim),
        "w_gu": (t.hidden, 2 * t.ffn_dim),
        "w_down": (t.ffn_dim, t.hidden),
    }
    linear = jax.jit(quant.linear)
    checks = []
    for i, (name, (K, N)) in enumerate(shapes.items()):
        kw, kx = jax.random.split(jax.random.key(seed + i))
        w = 0.02 * jax.random.normal(kw, (K, N))
        x = jax.random.normal(kx, (rows, K)).astype(jnp.bfloat16)
        kinds = [("int8", quant.quantize, quant.dequantize)]
        if K % (2 * quant.GROUP4) == 0:
            kinds.append(("int4", quant.quantize_int4, quant.dequantize4))
        for kind, qfn, dqfn in kinds:
            qw = qfn(w)
            got = linear(x, qw).astype(jnp.float32)
            with jax.default_matmul_precision("highest"):
                ref = x.astype(jnp.float32) @ dqfn(qw)
            checks.append(Check(
                f"quant.linear {kind} {name} [{rows},{K}]x[{K},{N}] vs "
                f"dequantize + f32", rel_err(got, ref), *TOL_QUANT,
                precision="bf16 x, default vs f32 highest"))
    return checks


def check_vocoder(cfg: EngineConfig, seed: int = 0,
                  frames: int = 16) -> List[Check]:
    vcfg = cfg.vocoder
    params = vocoder.with_dtype(
        vocoder.init_vocoder(jax.random.key(seed), vcfg), vcfg)
    codes = jax.random.randint(jax.random.key(seed + 1), (1, frames, 16), 0,
                               vcfg.code_vocab, jnp.int32)
    one, valid, _ = vocoder.decode(params, vcfg, codes,
                                   vocoder.init_state(vcfg, 1), True)
    one = np.asarray(one)[:, : int(valid[0])]
    state = vocoder.init_state(vcfg, 1)
    parts = []
    for s in range(0, frames, P.STREAM_CHUNK_FRAMES):
        last = s + P.STREAM_CHUNK_FRAMES >= frames
        wav, valid, state = vocoder.decode(
            params, vcfg, codes[:, s:s + P.STREAM_CHUNK_FRAMES], state, last)
        parts.append(np.asarray(wav)[:, : int(valid[0])])
    chunked = np.concatenate(parts, axis=1)
    if chunked.shape != one.shape or not np.isfinite(chunked).all():
        raise AssertionError(f"vocoder: chunked {chunked.shape} vs one-shot "
                             f"{one.shape}, finite={np.isfinite(chunked).all()}")
    return [Check(f"vocoder {P.STREAM_CHUNK_FRAMES}-frame chunked vs one-shot "
                  f"({frames} frames, {vcfg.dtype} trunk)",
                  rel_err(chunked, one), *TOL_VOCODER,
                  precision=f"{vcfg.dtype} default on both sides")]


def run_checks(cfg: EngineConfig, seed: int = 0) -> List[Check]:
    checks = []
    for phase in (check_talker, check_predictor, check_quant, check_vocoder):
        for c in phase(cfg, seed):
            print(c.line(), flush=True)
            checks.append(c)
    return checks


def _post(port: int, body: dict, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/tts", body=json.dumps(body))
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _wav_samples(data: bytes) -> np.ndarray:
    if data[:4] != b"RIFF" or len(data) <= 44:
        raise AssertionError(f"not a non-empty WAV ({len(data)} bytes)")
    return np.frombuffer(data[44:44 + (len(data) - 44) // 2 * 2], "<i2")


def _check_audio(samples, what: str) -> int:
    samples = np.asarray(samples)
    n = samples.size
    if n == 0 or n % P.FRAME_SAMPLES or not np.isfinite(samples).all():
        raise AssertionError(f"{what}: {n} samples, finite="
                             f"{np.isfinite(samples).all()}")
    return n // P.FRAME_SAMPLES


def run_main_path(cfg: EngineConfig, seed: int = 0, max_steps: int = 64,
                  max_streams: int = 4, timeout: float = 900.0) -> dict:
    """Offline, streamed and served synthesis through the entry points a
    user calls. Returns informational timings and counts."""
    info = {}
    t0 = time.perf_counter()
    engine = TtsEngine(config=cfg, random_weights=True, seed=seed,
                       speakers_dir=SPEAKERS_DIR)
    engine.set_max_steps(max_steps)
    engine.set_sampler_config(SamplerConfig(seed=seed))
    voice = engine.get_speaker("vivian")
    text = "你好，欢迎使用 Qwen3-TTS。This is a smoke test."
    info["engine_init_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    audio = engine.generate_with_voice(text, voice)
    info["offline_first_call_s"] = time.perf_counter() - t0
    info["offline_frames"] = _check_audio(audio.samples, "offline")
    t0 = time.perf_counter()
    _check_audio(engine.generate_with_voice(text, voice).samples, "offline")
    info["offline_second_call_s"] = time.perf_counter() - t0

    chunks = []
    t0 = time.perf_counter()
    streamed = engine.generate_stream(text, voice, on_chunk=chunks.append)
    info["stream_first_call_s"] = time.perf_counter() - t0
    info["stream_frames"] = _check_audio(streamed.samples, "stream")
    info["stream_chunks"] = len(chunks)
    if len(chunks) < 2:
        raise AssertionError(f"stream yielded {len(chunks)} chunks, want >= 2")

    srv = server_mod.TtsServer(engine, max_streams=max_streams)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server_mod.make_handler(srv))
    port = httpd.server_address[1]
    serve = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve.start()
    results = {}

    def hit(i):
        try:
            results[i] = _post(port, {"text": f"{text} #{i}",
                                      "speaker": "vivian",
                                      "stream": i == 0}, timeout)
        except Exception as e:          # reported below, never hidden
            results[i] = e

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=timeout)
        info["http_3_requests_s"] = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
    frames = []
    for i in range(3):
        r = results.get(i)
        if not isinstance(r, tuple):
            raise AssertionError(f"HTTP request {i} failed: {r!r}")
        status, ctype, data = r
        if status != 200 or ctype != "audio/wav":
            raise AssertionError(f"HTTP request {i}: {status} {ctype} "
                                 f"{data[:200]!r}")
        frames.append(len(_wav_samples(data)) // P.FRAME_SAMPLES)
    info["http_frames"] = frames
    return info


def main() -> int:
    device = profiling.device_record()
    if device["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {device}", file=sys.stderr)
        return 2
    print(f"card: {profiling.card_info()}", flush=True)
    print(f"jax {jax.__version__}; devices: {device['count']} x "
          f"{device['kind']}", flush=True)
    cfg = EngineConfig()
    print("precision: talker and predictor bf16 weights and activations; "
          f"vocoder trunk {cfg.vocoder.dtype} at default matmul precision",
          flush=True)
    checks = run_checks(cfg)
    failed = [c.name for c in checks if not c.ok]
    info = run_main_path(cfg)
    info["peak_bytes_in_use"] = \
        jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print("info (not benchmark metrics): " + json.dumps(info), flush=True)
    if failed:
        print(f"chip_smoke: {len(failed)} check(s) failed: {failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
