"""Backend dispatch: with the backend reported as "gpu", the flagship-shaped
decode step, the quantized matmuls and the whole generation program trace
to plain XLA — no Pallas call, and no module of the package imports
Pallas. Shapes come from `jax.eval_shape`, so nothing is
allocated or compiled."""

import os
import re

import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.assets import tables
from qwen3_tts_tpu.core import protocol as P
from qwen3_tts_tpu.core.config import EngineConfig
from qwen3_tts_tpu.models import decoder, vocoder
from qwen3_tts_tpu.ops import quant
from qwen3_tts_tpu.tts import generate

CFG = EngineConfig()
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "qwen3_tts_tpu")


def _abstract(fn, *args):
    return jax.eval_shape(fn, *args)


def _s1_forward(cfg, window):
    params = _abstract(lambda: decoder.init_decoder(jax.random.key(0), cfg))
    x = jax.ShapeDtypeStruct((1, 1, cfg.hidden), jnp.dtype(cfg.dtype))
    pos = jax.ShapeDtypeStruct((1, 1), jnp.int32)
    cache = _abstract(lambda: decoder.init_kv_cache(cfg, 1, length=window))
    valid = jax.ShapeDtypeStruct((1,), jnp.int32)
    return jax.make_jaxpr(
        lambda p, x, pos, c, v: decoder.forward(
            p, cfg, x, pos, c, jnp.int32(5), kv_valid_from=v)
    )(params, x, pos, cache, valid)


def _linear(kind, M=1):
    t = CFG.talker
    K, N = t.hidden, 2 * t.ffn_dim
    w = jax.ShapeDtypeStruct((K, N), jnp.bfloat16)
    if kind == "int8":
        w = _abstract(quant.quantize, w)
    elif kind == "int4":
        w = _abstract(quant.quantize_int4, w)
    x = jax.ShapeDtypeStruct((M, K), jnp.bfloat16)
    return jax.make_jaxpr(quant.linear)(x, w)


def _generate_audio():
    k = jax.random.key(0)
    models = _abstract(lambda: {
        "talker": quant.quantize_decoder_params(
            decoder.init_decoder(k, CFG.talker), "int4"),
        "predictor": quant.quantize_decoder_params(
            decoder.init_decoder(k, CFG.predictor), "int8"),
        "assets": tables.random_assets(
            k, text_vocab=P.TEXT_VOCAB, codec_rows=3072,
            dim=CFG.talker.hidden, proj_dim=CFG.predictor.hidden),
    })
    voc = _abstract(lambda: vocoder.init_vocoder(k, CFG.vocoder))
    prompt = jax.ShapeDtypeStruct((2, 64, CFG.talker.hidden), jnp.bfloat16)
    pad = jax.ShapeDtypeStruct((2,), jnp.int32)
    return jax.make_jaxpr(
        lambda m, v, p, o: generate.generate_audio(
            m, v, CFG.talker, CFG.predictor, CFG.vocoder, p, o,
            jax.random.key(1), 0.7, 40, 0.9, 16)
    )(models, voc, prompt, pad)


CASES = {
    "talker_decode_step": lambda: _s1_forward(CFG.talker, 1024),
    "predictor_decode_step": lambda: _s1_forward(CFG.predictor,
                                                 CFG.predictor.max_seq),
    "linear_dense": lambda: _linear("dense"),
    "linear_int8": lambda: _linear("int8"),
    "linear_int4": lambda: _linear("int4"),
    "linear_int8_m32": lambda: _linear("int8", M=32),
    "generate_audio_int4_int8": _generate_audio,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpu_backend_traces_plain_xla(case, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jaxpr = str(CASES[case]())
    assert "pallas_call" not in jaxpr
    assert "custom_call" not in jaxpr


def test_no_pallas_imports():
    """The package has no hand-written kernels: no module imports any
    Pallas backend."""
    pat = re.compile(r"^\s*(from|import)\s.*\bpallas\b", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as f:
                    if pat.search(f.read()):
                        offenders.append(path)
    assert offenders == []
