#!/usr/bin/env python
"""Kernel decisions on one GPU: the measurements behind PERF.md's
"Kernel decisions" table, at the flagship widths with seeded random weights.

  1. Talker decode attention, B=1 and B=32, inside the streaming step
     program (4 frames of talker step + code_0 sampling + predictor
     expansion per call, 1024-slot talker window) and inside the offline
     generation loop (64 frames, cache sized to prompt + frames): the
     plain `attention.gqa_attention` against JAX's shipped Triton decode
     kernel (library code:
     `jax.experimental.pallas.ops.gpu.decode_attention.gqa`, which reads
     only the valid prefix of the window), timed in alternating rounds.
     Also counts copies of the carried talker cache in the compiled step.
  2. Weight-only int8 and int4 `quant.linear` against bf16 at the four
     talker matmul shapes, M=1 and M=32: time per layer over a scan of 28
     stacked layers, and the bytes each format has to read.
  3. The plain talker decode step (donated cache) and predictor frame
     expansion, bf16 and quantized, B=1 and B=32: the times a future
     hand-written kernel has to beat.
  4. A short profiler trace of the plain stream step at B=1 and B=32,
     reduced to busy time, top ops and copies per device line.

Host clock around calls that end in block_until_ready; medians of repeated
runs after compile and warm-up. Refuses any device but a GPU.

Usage: python tools/kernel_decisions.py [decode|linear|steps|trace ...]
           [--out chiprun_out/kernel_decisions.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qwen3_tts_tpu.assets import tables  # noqa: E402
from qwen3_tts_tpu.core import protocol as P  # noqa: E402
from qwen3_tts_tpu.core.config import EngineConfig  # noqa: E402
from qwen3_tts_tpu.models import decoder, predictor, talker  # noqa: E402
from qwen3_tts_tpu.ops import attention, quant  # noqa: E402
from qwen3_tts_tpu.tts import generate  # noqa: E402
from qwen3_tts_tpu.utils import profiling  # noqa: E402

WINDOW = 1024
PROMPT = 64


def median_s(fn, runs: int = 7, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


_plain_attention = attention.gqa_attention


def library_decode_attention(q, k, v, q_start, kv_len, kv_valid_from=None):
    """S=1 talker-window attention through JAX's Triton decode kernel;
    everything else (prefill, the 32-slot predictor) stays plain."""
    B, S, nq, hd = q.shape
    if S != 1 or k.shape[2] < 256:
        return _plain_attention(q, k, v, q_start, kv_len, kv_valid_from)
    from jax.experimental.pallas.ops.gpu import decode_attention as lib
    start = (jnp.zeros((B,), jnp.int32) if kv_valid_from is None
             else jnp.asarray(kv_valid_from, jnp.int32))
    kv_len = jnp.broadcast_to(jnp.asarray(kv_len, jnp.int32), (B,))
    # the kernel takes [B, T, nk, hd] and swaps back to head-major inside;
    # the two transposes cancel in XLA
    out = lib.gqa(q[:, 0], jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
                  start_idx=start, kv_seq_len=kv_len)
    return out[:, None].astype(q.dtype)    # the library returns float32


@contextlib.contextmanager
def attention_impl(fn):
    attention.gqa_attention = fn
    try:
        yield
    finally:
        attention.gqa_attention = _plain_attention


def cache_copies(compiled, shape) -> int:
    """Lines of the optimized HLO that copy an array of the cache's shape."""
    dims = ",".join(str(d) for d in shape)
    pat = re.compile(rf"bf16\[{dims}\]\S* (copy|copy-start)\(")
    return sum(1 for line in compiled.as_text().splitlines()
               if pat.search(line))


def _stream_runner(cfg, models, batch, fn):
    """The serving step program (4 frames per call, WINDOW-slot talker
    cache) traced with `fn` as the attention; returns (run, record)."""
    prompt = 0.1 * jax.random.normal(
        jax.random.key(9), (batch, PROMPT, cfg.talker.hidden), jnp.bfloat16)
    pad = jnp.zeros((batch,), jnp.int32)
    with attention_impl(fn):
        prefill_fn, step_fn = generate.make_stream_fns(
            cfg.talker, cfg.predictor, 40,
            frames_per_call=P.STREAM_CHUNK_FRAMES, cache_len=WINDOW)
        state = prefill_fn(models, prompt, pad, jax.random.key(1), 0.7, 0.9)
        t0 = time.perf_counter()
        compiled = step_fn.lower(models, state).compile()
        compile_s = time.perf_counter() - t0
    box = {"state": state}

    def run():
        box["state"], codes, _ = compiled(models, box["state"])
        codes.block_until_ready()

    return run, P.STREAM_CHUNK_FRAMES, {
        "compile_s": compile_s,
        "cache_bytes_k_plus_v": 2 * state["cache"]["k"].nbytes,
        "temp_bytes": compiled.memory_analysis().temp_size_in_bytes,
        "cache_shaped_copies_in_hlo": cache_copies(
            compiled, state["cache"]["k"].shape)}


def _offline_runner(cfg, models, batch, fn, steps: int = 64):
    """The offline generation loop (generate_codes, EOS masked, cache sized
    to prompt + steps) traced with `fn` as the attention."""
    prompt = 0.1 * jax.random.normal(
        jax.random.key(9), (batch, PROMPT, cfg.talker.hidden), jnp.bfloat16)
    pad = jnp.zeros((batch,), jnp.int32)
    # a fresh closure over the undecorated loop, so each variant traces anew
    def loop(models, prompt, pad, key, temperature, top_p):
        return generate.generate_codes.__wrapped__(
            models, cfg.talker, cfg.predictor, prompt, pad, key, temperature,
            40, top_p, steps, ignore_eos=True)

    dyn = (models, prompt, pad, jax.random.key(1), 0.7, 0.9)
    with attention_impl(fn):
        t0 = time.perf_counter()
        compiled = jax.jit(loop).lower(*dyn).compile()
        compile_s = time.perf_counter() - t0

    def run():
        codes, _ = compiled(*dyn)
        codes.block_until_ready()

    return run, steps, {
        "compile_s": compile_s,
        "cache_window": generate.cache_window(cfg.talker, PROMPT, steps),
        "temp_bytes": compiled.memory_analysis().temp_size_in_bytes}


def decode_attention_section(cfg, models, out, rounds: int = 4):
    """Plain vs library attention, timed in alternating rounds (plain,
    library, library, plain, ...) so drift hits both alike."""
    res = {}
    for setting, runner in (("stream_w1024", _stream_runner),
                            ("offline_steps64", _offline_runner)):
        for batch in (1, 32):
            variants = {name: runner(cfg, models, batch, fn) for name, fn in
                        (("plain", _plain_attention),
                         ("triton_library", library_decode_attention))}
            times = {name: [] for name in variants}
            for r in range(rounds):
                order = list(variants) if r % 2 == 0 else list(variants)[::-1]
                for name in order:
                    run, frames, _ = variants[name]
                    times[name].append(1e3 * median_s(run, runs=5) / frames)
            for name, (_, _, rec) in variants.items():
                ts = sorted(times[name])
                rec = dict(rec, frame_ms_rounds=times[name],
                           frame_ms_median=ts[len(ts) // 2])
                res[f"{setting}_b{batch}_{name}"] = rec
                print(f"decode attention {setting} B={batch} {name}: "
                      f"{json.dumps(rec)}", flush=True)
            del variants
    # one-step numerical agreement of the two attention routes
    for batch in (1, 32):
        q = jax.random.normal(jax.random.key(3), (batch, 1, 16, 128),
                              jnp.bfloat16)
        kv = jax.random.normal(jax.random.key(4), (2, batch, 8, WINDOW, 128),
                               jnp.bfloat16)
        pad = jnp.zeros((batch,), jnp.int32)
        a = _plain_attention(q, kv[0], kv[1], 100, 101, pad)
        b = library_decode_attention(q, kv[0], kv[1], 100, 101, pad)
        res[f"b{batch}_max_abs_diff"] = float(jnp.max(jnp.abs(
            a.astype(jnp.float32) - b.astype(jnp.float32))))
        print(f"decode attention B={batch} plain vs library max|diff| "
              f"{res[f'b{batch}_max_abs_diff']:.3e}", flush=True)
    out["decode_attention"] = res


def _is_copy(name: str) -> bool:
    """XLA copy ops and the driver's device-to-device memcpys."""
    return "copy" in name.lower() or "memcpy" in name.lower()


def reduce_trace(path: str, top: int = 12) -> dict:
    """Per device line of an .xplane.pb: event count, busy time (union of
    the event intervals), the line's span, and the names that take the
    most time."""
    pd = jax.profiler.ProfileData.from_file(path)
    res = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if not evs:
                continue
            by_name = {}
            for name, _, dur in evs:
                c = by_name.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += dur
            busy, end = 0.0, None
            for s0, s1 in sorted((s, s + d) for _, s, d in evs):
                if end is None or s0 > end:
                    busy += s1 - s0
                    end = s1
                elif s1 > end:
                    busy += s1 - end
                    end = s1
            span = max(s + d for _, s, d in evs) - min(s for _, s, _ in evs)
            res[f"{plane.name} | {line.name}"] = {
                "events": len(evs), "busy_ms": busy / 1e6,
                "span_ms": span / 1e6,
                "top": [(n, c, t / 1e6) for n, (c, t) in sorted(
                    by_name.items(), key=lambda kv: -kv[1][1])[:top]],
                "copy_events": sum(c for n, (c, _) in by_name.items()
                                   if _is_copy(n)),
                "copy_ms": sum(t for n, (_, t) in by_name.items()
                               if _is_copy(n)) / 1e6,
            }
    return res


def trace_section(cfg, models, out, trace_dir: str, calls: int = 3):
    """A short profiler trace of the plain stream step (4 frames a call)
    at B=1 and B=32, reduced to per-line busy time and top ops."""
    import glob
    import shutil

    res = {}
    for batch in (1, 32):
        run, frames, _ = _stream_runner(cfg, models, batch, _plain_attention)
        for _ in range(2):
            run()
        d = os.path.join(trace_dir, f"b{batch}")
        shutil.rmtree(d, ignore_errors=True)
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            wall = time.perf_counter() - t0
        path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        rec = {"frames": calls * frames, "wall_ms": 1e3 * wall,
               "lines": reduce_trace(path)}
        shutil.rmtree(d, ignore_errors=True)
        res[f"stream_b{batch}"] = rec
        print(f"trace stream B={batch}: {json.dumps(rec)}", flush=True)
    out["trace"] = res


def linear_section(cfg, out, layers: int = 28, reps: int = 20):
    t = cfg.talker
    shapes = {
        "wqkv": (t.hidden, (t.n_q_heads + 2 * t.n_kv_heads) * t.head_dim),
        "wo": (t.n_q_heads * t.head_dim, t.hidden),
        "w_gu": (t.hidden, 2 * t.ffn_dim),
        "w_down": (t.ffn_dim, t.hidden),
    }
    res = {}
    for name, (K, N) in shapes.items():
        w = (0.02 * jax.random.normal(jax.random.key(0), (layers, K, N))
             ).astype(jnp.bfloat16)
        stacks = {
            "bf16": (w, 2 * K * N),
            "int8": (jax.vmap(quant.quantize)(w), K * N + 4 * N),
            "int4": (jax.lax.map(quant.quantize_int4, w),
                     K * N // 2 + K * N // quant.GROUP4 + 4 * N),
        }
        for M in (1, 32):
            x = jax.random.normal(jax.random.key(1), (M, K), jnp.bfloat16)
            for kind, (ws, nbytes) in stacks.items():
                def body(acc, wl):
                    return acc + quant.linear(x, wl).astype(jnp.float32), None

                f = jax.jit(lambda ws: jax.lax.scan(
                    body, jnp.zeros((M, N), jnp.float32), ws)[0])
                compiled = f.lower(ws).compile()

                def run():
                    for _ in range(reps):
                        y = compiled(ws)
                    y.block_until_ready()

                us = 1e6 * median_s(run, runs=5) / (reps * layers)
                rec = {"us_per_layer": us, "weight_bytes": nbytes,
                       "GBps": nbytes / us / 1e3,
                       "temp_bytes": compiled.memory_analysis()
                       .temp_size_in_bytes}
                res[f"{name}_m{M}_{kind}"] = rec
                print(f"linear {name} [{M},{K}]x[{K},{N}] {kind}: "
                      f"{json.dumps(rec)}", flush=True)
        del stacks, w
    out["linear"] = res


def step_section(cfg, dense, out):
    res = {}
    variants = {
        "bf16": dense,
        "int4_talker_int8_predictor": dict(
            dense,
            talker=quant.quantize_decoder_params(dense["talker"], "int4"),
            predictor=quant.quantize_decoder_params(dense["predictor"],
                                                    "int8")),
    }
    step = jax.jit(talker.step, static_argnums=(1,), donate_argnums=(5,))
    frame = jax.jit(predictor.frame_codes, static_argnums=(1,))
    for vname, mdl in variants.items():
        for batch in (1, 32):
            fb = 0.1 * jax.random.normal(
                jax.random.key(5), (batch, cfg.talker.hidden), jnp.bfloat16)
            pad = jnp.zeros((batch,), jnp.int32)
            box = {"cache": decoder.init_kv_cache(cfg.talker, batch,
                                                  length=WINDOW)}

            def run_step():
                h, lg, box["cache"] = step(mdl["talker"], cfg.talker, fb,
                                           jnp.int32(PROMPT), pad,
                                           box["cache"])
                lg.block_until_ready()

            h1024 = jax.random.normal(jax.random.key(6),
                                      (batch, cfg.predictor.hidden))
            c0 = jnp.zeros((batch,), jnp.int32)

            def run_frame():
                frame(mdl["predictor"], cfg.predictor, mdl["assets"], h1024,
                      c0).block_until_ready()

            rec = {"talker_step_ms": 1e3 * median_s(run_step),
                   "predictor_frame_ms": 1e3 * median_s(run_frame)}
            res[f"{vname}_b{batch}"] = rec
            print(f"plain step {vname} B={batch}: {json.dumps(rec)}",
                  flush=True)
        del mdl
    out["plain_steps"] = res


SECTIONS = ("decode", "linear", "steps", "trace")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sections", nargs="*", default=list(SECTIONS),
                    choices=SECTIONS)
    ap.add_argument("--out", default="chiprun_out/kernel_decisions.json")
    args = ap.parse_args(argv)
    device = profiling.device_record()
    if device["platform"] != "gpu":
        print(f"kernel_decisions: needs a GPU, JAX found {device}",
              file=sys.stderr)
        return 2
    out = {"card": profiling.card_info(), "device": device,
           "jax": jax.__version__}
    print(f"card: {out['card']}; {device}", flush=True)
    cfg = EngineConfig()
    k = jax.random.split(jax.random.key(0), 3)
    dense = {
        "talker": decoder.init_decoder(k[0], cfg.talker),
        "predictor": decoder.init_decoder(k[1], cfg.predictor),
        "assets": tables.random_assets(
            k[2], text_vocab=P.TEXT_VOCAB, codec_rows=3072,
            dim=cfg.talker.hidden, proj_dim=cfg.predictor.hidden),
    }
    if "decode" in args.sections:
        decode_attention_section(cfg, dense, out)
    if "linear" in args.sections:
        linear_section(cfg, out)
    if "steps" in args.sections:
        step_section(cfg, dense, out)
    if "trace" in args.sections:
        trace_section(cfg, dense, out, os.path.join(
            os.path.dirname(os.path.abspath(args.out)), "trace"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
