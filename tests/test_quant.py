"""Int8/int4 quantization: numeric bounds, the plain quantized matmul,
quantized decoder forward parity and end-to-end generation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.assets import tables
from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import decoder
from qwen3_tts_tpu.ops import quant
from qwen3_tts_tpu.tts import generate

CFG = tiny_engine_config(max_steps=4)


def test_quantize_dequantize_error_bound():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32) * 0.1)
    qw = quant.quantize(w)
    assert qw["q"].dtype == jnp.int8
    err = np.abs(np.asarray(quant.dequantize(qw)) - np.asarray(w))
    # per-channel scale bounds the error at scale/2 per element
    bound = np.asarray(qw["scale"]) * 0.5 + 1e-8
    assert (err <= bound[None, :] + 1e-6).all()


def test_qmatmul_matches_dequant_reference():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(3, 256)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32) * 0.05)
    qw = quant.quantize(w)
    got = np.asarray(quant.qmatmul(x, qw))
    want = np.asarray(x) @ np.asarray(quant.dequantize(qw))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_qmatmul_plain_form(dtype):
    """int8 qmatmul is one dot of x against the weight widened to x.dtype,
    accumulated in f32, then scaled — on every backend."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 3, 256)), dtype)
    qw = quant.quantize(jnp.asarray(rng.normal(size=(256, 384)) * 0.05,
                                    jnp.float32))
    got = quant.qmatmul(x, qw)
    assert got.shape == (2, 3, 384) and got.dtype == jnp.float32
    want = jax.lax.dot_general(
        x.reshape(6, 256), qw["q"].astype(dtype), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32) * qw["scale"]
    np.testing.assert_array_equal(np.asarray(got).reshape(6, 384),
                                  np.asarray(want))
    # and it agrees with dequantize + f32: the only rounding is x's dtype
    ref = (np.asarray(x, np.float32).reshape(6, 256)
           @ np.asarray(quant.dequantize(qw)))
    np.testing.assert_allclose(np.asarray(got).reshape(6, 384), ref,
                               rtol=1e-4, atol=1e-4)
    assert quant.linear(x, qw).dtype == dtype


def test_int4_quantizer_roundtrip():
    w = 0.3 * jax.random.normal(jax.random.key(0), (512, 384))
    q = quant.quantize_int4(w)
    assert q["q4"].shape == (256, 384) and q["m8"].shape == (4, 384)
    rel = float(jnp.abs(quant.dequantize4(q) - w).mean()
                / jnp.abs(w).mean())
    assert rel < 0.2, rel                     # Q4-class quantization error
    # packing round-trip is exact
    nib = quant.unpack4(q["q4"])
    assert int(jnp.max(nib)) <= 7 and int(jnp.min(nib)) >= -7
    x = jax.random.normal(jax.random.key(1), (4, 512), jnp.float32)
    y = quant.qmatmul4(x, q)
    ref = (x @ quant.dequant4_dt(q["q4"], q["m8"], x.dtype)) * q["scale"]
    assert jnp.allclose(y, ref, rtol=1e-6)


def test_quantized_decoder_forward_close_to_dense():
    params = decoder.init_decoder(jax.random.key(0), CFG.talker)
    qparams = quant.quantize_decoder_params(params)
    assert qparams["layers"]["wqkv"]["q"].dtype == jnp.int8
    x = 0.1 * jax.random.normal(jax.random.key(1), (1, 4, CFG.talker.hidden))
    pos = jnp.arange(4, dtype=jnp.int32)[None]
    cache = decoder.init_kv_cache(CFG.talker, 1)
    _, logits_d, _ = decoder.forward(params, CFG.talker, x, pos, cache,
                                     jnp.int32(0))
    _, logits_q, _ = decoder.forward(qparams, CFG.talker, x, pos, cache,
                                     jnp.int32(0))
    d = np.asarray(logits_d)
    q = np.asarray(logits_q)
    # int8 noise is small relative to logit scale; argmax usually agrees
    assert np.abs(d - q).mean() < 0.05 * (np.abs(d).mean() + 1e-6) + 0.05


def test_quantized_generation_runs():
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    models = {
        "talker": quant.quantize_decoder_params(
            decoder.init_decoder(k1, CFG.talker)),
        "predictor": quant.quantize_decoder_params(
            decoder.init_decoder(k2, CFG.predictor)),
        "assets": tables.random_assets(
            k3, text_vocab=256, codec_rows=2176,
            dim=CFG.talker.hidden, proj_dim=CFG.predictor.hidden),
    }
    prompt = 0.1 * jax.random.normal(jax.random.key(5),
                                     (1, 5, CFG.talker.hidden))
    codes, n = generate.generate_codes(
        models, CFG.talker, CFG.predictor, prompt,
        jnp.zeros((1,), jnp.int32), jax.random.key(0), 0.0, 0, 1.0,
        CFG.max_steps)
    assert int(n[0]) >= 1
    c = np.asarray(codes)[0, : int(n[0])]
    assert (c >= 0).all() and (c[:, 0] < 2160).all()
