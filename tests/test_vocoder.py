"""Vocoder: the reference's carried-state streaming contract
(src/models/onnx.rs:342-496), now with REAL contract strength:

  * variable `valid_samples` — non-final calls withhold the lookahead
    window (src/models/onnx.rs:398-405);
  * `is_last` flushes it;
  * chunked decode (with trimming + final flush) is bit-comparable to
    one-shot decode;
  * an independent numpy oracle locks the derived architecture
    (embed-sum -> causal pre-conv -> transformer -> centered lookahead
    conv -> causal conv -> frame-local transposed-conv upsampler).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.core.config import tiny_engine_config
from qwen3_tts_tpu.models import vocoder

from test_numpy_oracle import np_forward

CFG = tiny_engine_config().vocoder
LA = CFG.lookahead
F = CFG.frame_samples


@pytest.fixture(scope="module")
def params():
    return vocoder.init_vocoder(jax.random.key(0), CFG)


def _codes(n_frames, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.integers(0, CFG.code_vocab, size=(batch, n_frames, 16)), jnp.int32
    )


def test_shapes_and_variable_valid(params):
    codes = _codes(5)
    state = vocoder.init_state(CFG, 1)
    wav, valid, state = vocoder.decode(params, CFG, codes, state, False)
    assert wav.shape == (1, (5 + LA) * F)
    # stream start: the lookahead window is withheld on non-final calls
    assert valid.tolist() == [(5 - LA) * F]
    assert int(state.frames_done[0]) == 5
    # second call: steady state emits every frame
    wav2, valid2, state = vocoder.decode(params, CFG, _codes(3, seed=1),
                                         state, False)
    assert valid2.tolist() == [3 * F]
    # final call flushes the lookahead
    wav3, valid3, _ = vocoder.decode(params, CFG, _codes(2, seed=2),
                                     state, True)
    assert valid3.tolist() == [(2 + LA) * F]
    assert np.isfinite(np.asarray(wav)).all()


def test_oneshot_valid_covers_everything(params):
    codes = _codes(6)
    wav, valid, _ = vocoder.decode(params, CFG, codes,
                                   vocoder.init_state(CFG, 1), True)
    assert valid.tolist() == [6 * F]


def test_streaming_equals_oneshot(params):
    """4-frame chunks + remainder (the reference's 64-code batching,
    src/tts/engine.rs:510-537) must reproduce the one-shot waveform,
    including the is_last flush."""
    total = 11
    codes = _codes(total, seed=3)

    state = vocoder.init_state(CFG, 1)
    one_shot, v, _ = vocoder.decode(params, CFG, codes, state, True)
    one_shot = np.asarray(one_shot)[:, : int(v[0])]
    assert one_shot.shape[1] == total * F

    state = vocoder.init_state(CFG, 1)
    chunks = []
    for start in range(0, total, 4):
        part = codes[:, start:start + 4]
        last = start + 4 >= total
        wav, valid, state = vocoder.decode(params, CFG, part, state, last)
        chunks.append(np.asarray(wav)[:, : int(valid[0])])
    streamed = np.concatenate(chunks, axis=1)

    assert streamed.shape == one_shot.shape
    np.testing.assert_allclose(streamed, one_shot, rtol=1e-5, atol=1e-5)


def test_bf16_trunk_matches_f32(params):
    """bf16 transformer trunk (vocoder.with_dtype):
    same streaming contract, waveform close to f32, chunked==one-shot still
    holds within bf16 tolerance."""
    import dataclasses

    cfg16 = dataclasses.replace(CFG, dtype="bfloat16")
    p16 = vocoder.with_dtype(params, cfg16)
    total = 9
    codes = _codes(total, seed=5)

    w32, v32, _ = vocoder.decode(params, CFG, codes,
                                 vocoder.init_state(CFG, 1), True)
    w16, v16, _ = vocoder.decode(p16, cfg16, codes,
                                 vocoder.init_state(cfg16, 1), True)
    assert v32.tolist() == v16.tolist()
    a = np.asarray(w32)[0, : int(v32[0])]
    b = np.asarray(w16)[0, : int(v16[0])]
    # trunk rounding only: waveform deviation stays small relative to scale
    assert np.max(np.abs(a - b)) < 0.05 * max(np.max(np.abs(a)), 1e-3)

    state = vocoder.init_state(cfg16, 1)
    chunks = []
    for start in range(0, total, 4):
        part = codes[:, start:start + 4]
        wav, valid, state = vocoder.decode(p16, cfg16, part, state,
                                           start + 4 >= total)
        chunks.append(np.asarray(wav)[:, : int(valid[0])])
    streamed = np.concatenate(chunks, axis=1)
    np.testing.assert_allclose(streamed[0], b, rtol=2e-2, atol=2e-3)


def test_snake_activation_variant():
    """cfg.activation='snake' (x + sin^2(alpha*x)/alpha, per-channel): the
    streaming contract (chunked == one-shot, valid_samples) holds
    unchanged, and the activation is verifiably snake, not gelu."""
    import dataclasses

    scfg = dataclasses.replace(CFG, activation="snake")
    p = vocoder.init_vocoder(jax.random.key(2), scfg)
    assert "alpha" in p["pre_conv"] and "alpha" in p["up"][0]
    assert "alpha" not in p["up"][-1]          # waveform head stays tanh

    # closed-form check of the helper itself
    x = jnp.asarray(np.linspace(-2, 2, 8), jnp.float32).reshape(1, 1, 8)
    entry = {"alpha": jnp.asarray([0.5], jnp.float32)}
    got = vocoder._act(scfg, entry, x, 1)
    want = np.asarray(x) + np.sin(0.5 * np.asarray(x)) ** 2 / 0.5
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)

    total = 9
    codes = _codes(total, seed=7)
    one, v, _ = vocoder.decode(p, scfg, codes,
                               vocoder.init_state(scfg, 1), True)
    one = np.asarray(one)[:, : int(v[0])]
    assert one.shape[1] == total * F

    state = vocoder.init_state(scfg, 1)
    chunks = []
    for start in range(0, total, 4):
        part = codes[:, start:start + 4]
        wav, valid, state = vocoder.decode(p, scfg, part, state,
                                           start + 4 >= total)
        chunks.append(np.asarray(wav)[:, : int(valid[0])])
    streamed = np.concatenate(chunks, axis=1)
    np.testing.assert_allclose(streamed, one, rtol=1e-5, atol=1e-5)

    # differs from the gelu interpretation of the same weights
    gelu_like = {k: ({kk: vv for kk, vv in val.items() if kk != "alpha"}
                     if isinstance(val, dict) and "alpha" in val else val)
                 for k, val in p.items()}
    gelu_like["up"] = [{kk: vv for kk, vv in st.items() if kk != "alpha"}
                       for st in p["up"]]
    g, vg, _ = vocoder.decode(gelu_like, CFG, codes,
                              vocoder.init_state(CFG, 1), True)
    assert not np.allclose(np.asarray(g)[:, : int(vg[0])], one)


def test_flush_drains_pending(params):
    """A stream that ends between calls: flush() must emit exactly what an
    is_last submission would have."""
    total = 7
    codes = _codes(total, seed=4)

    state = vocoder.init_state(CFG, 1)
    w1, v1, state = vocoder.decode(params, CFG, codes, state, False)
    w2, v2, _ = vocoder.flush(params, CFG, state)
    got = np.concatenate([np.asarray(w1)[:, : int(v1[0])],
                          np.asarray(w2)[:, : int(v2[0])]], axis=1)

    ref, vr, _ = vocoder.decode(params, CFG, codes,
                                vocoder.init_state(CFG, 1), True)
    ref = np.asarray(ref)[:, : int(vr[0])]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_per_row_is_last(params):
    """Continuous batching: is_last may flush one row while the other keeps
    streaming."""
    codes = _codes(4, batch=2, seed=5)
    state = vocoder.init_state(CFG, 2)
    is_last = jnp.asarray([True, False])
    wav, valid, _ = vocoder.decode(params, CFG, codes, state, is_last)
    assert valid.tolist() == [4 * F, (4 - LA) * F]
    # the flushed row matches a solo one-shot decode
    solo, vs, _ = vocoder.decode(params, CFG, codes[:1],
                                 vocoder.init_state(CFG, 1), True)
    np.testing.assert_allclose(
        np.asarray(wav)[0, : int(valid[0])],
        np.asarray(solo)[0, : int(vs[0])], rtol=1e-5, atol=1e-6)


def test_code_clamping(params):
    """Out-of-range codes are clamped like the decoder thread's
    c.clamp(0, 2047) (src/tts/engine.rs:515-519)."""
    state = vocoder.init_state(CFG, 1)
    lo = jnp.full((1, 2, 16), -5, jnp.int32)
    hi = jnp.full((1, 2, 16), 99_999, jnp.int32)
    wav_lo, _, _ = vocoder.decode(params, CFG, lo, state, False)
    wav_zero, _, _ = vocoder.decode(
        params, CFG, jnp.zeros((1, 2, 16), jnp.int32), state, False)
    wav_hi, _, _ = vocoder.decode(params, CFG, hi, state, False)
    wav_max, _, _ = vocoder.decode(
        params, CFG, jnp.full((1, 2, 16), CFG.code_vocab - 1, jnp.int32),
        state, False)
    np.testing.assert_array_equal(np.asarray(wav_lo), np.asarray(wav_zero))
    np.testing.assert_array_equal(np.asarray(wav_hi), np.asarray(wav_max))


def test_batch_rows_independent(params):
    a = _codes(6, seed=1)
    b = _codes(6, seed=2)
    both = jnp.concatenate([a, b], axis=0)
    wav_b, _, _ = vocoder.decode(params, CFG, both,
                                 vocoder.init_state(CFG, 2), False)
    wav_a, _, _ = vocoder.decode(params, CFG, a,
                                 vocoder.init_state(CFG, 1), False)
    np.testing.assert_allclose(
        np.asarray(wav_b)[0], np.asarray(wav_a)[0], rtol=1e-5, atol=1e-6
    )


def test_gather_row_matches_solo(params):
    codes = _codes(5, batch=3, seed=6)
    state = vocoder.init_state(CFG, 3)
    _, _, state = vocoder.decode(params, CFG, codes, state, False)
    w_row, v_row, _ = vocoder.flush(params, CFG, vocoder.gather_row(state, 1))

    state1 = vocoder.init_state(CFG, 1)
    _, _, state1 = vocoder.decode(params, CFG, codes[1:2], state1, False)
    w_solo, v_solo, _ = vocoder.flush(params, CFG, state1)
    assert v_row.tolist() == v_solo.tolist()
    np.testing.assert_allclose(np.asarray(w_row), np.asarray(w_solo),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- numpy oracle
def _np_gelu(x):
    # jax.nn.gelu default (approximate=True, tanh form)
    return 0.5 * x * (1.0 + np.tanh(
        np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


def _np_conv_valid(x, w, b):
    """x [Cin, T], w [Cout, Cin, K] -> [Cout, T-K+1]."""
    Cout, Cin, K = w.shape
    T = x.shape[1] - K + 1
    out = np.zeros((Cout, T))
    for k in range(K):
        out += np.einsum("oi,it->ot", w[:, :, k], x[:, k:k + T])
    return out + b[:, None]


def np_vocoder_oneshot(params, cfg, codes):
    """Independent full-sequence decode: codes [N, 16] -> wav [N*2000]."""
    p = jax.tree.map(np.asarray, params)
    N = codes.shape[0]
    la, kp, kb = cfg.lookahead, cfg.pre_conv_kernel, cfg.post_conv_kernel

    emb = np.zeros((N, cfg.embed_dim))
    for q in range(cfg.num_codebooks):
        emb += p["embed"][q][np.clip(codes[:, q], 0, cfg.code_vocab - 1)]

    x = np.concatenate([np.zeros((cfg.embed_dim, kp - 1)), emb.T], axis=1)
    y = _np_gelu(_np_conv_valid(x, p["pre_conv"]["w"], p["pre_conv"]["b"]))

    tcfg = vocoder.transformer_config(cfg)
    h, _ = np_forward(params["transformer"], tcfg, y.T.astype(np.float32),
                      np.arange(N))

    a_in = np.concatenate(
        [np.zeros((cfg.hidden, la)), h.T, np.zeros((cfg.hidden, la))], axis=1)
    a = _np_gelu(_np_conv_valid(a_in, p["post_a"]["w"], p["post_a"]["b"]))
    b_in = np.concatenate([np.zeros((cfg.hidden, kb - 1)), a], axis=1)
    bb = _np_gelu(_np_conv_valid(b_in, p["post_b"]["w"], p["post_b"]["b"]))

    z = bb.T                                       # [N, hidden]
    n_up = len(p["up"])
    for i, (stage, s) in enumerate(zip(p["up"], cfg.upsample_factors)):
        z = z @ stage["w"] + stage["b"]
        c_out = stage["w"].shape[1] // s
        z = z.reshape(z.shape[0] * s, c_out)
        z = np.tanh(z) if i == n_up - 1 else _np_gelu(z)
    return z[:, 0]


def test_matches_numpy_oracle(params):
    codes = np.random.default_rng(9).integers(0, CFG.code_vocab, (6, 16))
    want = np_vocoder_oneshot(params, CFG, codes)

    wav, valid, _ = vocoder.decode(
        params, CFG, jnp.asarray(codes, jnp.int32)[None],
        vocoder.init_state(CFG, 1), True)
    got = np.asarray(wav)[0, : int(valid[0])]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# --------------------------------------------- general upsampler (DAC/BigVGAN)
# kernel != stride transposed convs (overlap-add across chunk boundaries),
# residual dilated conv units per stage, final output conv. The reference
# serves this family as an opaque ONNX graph (src/models/onnx.rs:324-496);
# here the streaming path must stay bit-exact vs one-shot.

import dataclasses  # noqa: E402

GCFG = dataclasses.replace(
    CFG,
    upsample_kernels=(10, 10, 10, 8, 8),     # k ~ 2s (DAC shape)
    resblock_dilations=(1, 3),
    resblock_kernel=7,
    final_conv_kernel=7,
)
GCFG_SNAKE = dataclasses.replace(GCFG, activation="snake")


def _assert_ulp_equal(got, want):
    """Streamed output must equal one-shot up to conv reduction-order ulps:
    the overlap-recompute window runs the SAME math, but XLA convolutions
    reassociate differently across window extents (observed <= ~1e-14)."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12)


@pytest.fixture(scope="module")
def gparams():
    return vocoder.init_vocoder(jax.random.key(1), GCFG)


def _gcodes(n_frames, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.integers(0, GCFG.code_vocab, size=(batch, n_frames, 16)),
        jnp.int32)


def test_general_ctx_is_positive():
    ctx_l, ctx_r = vocoder.up_context(GCFG)
    assert ctx_l > 0 and ctx_r > 0          # overlap-add => real lookahead
    assert vocoder.up_context(CFG) == (0, 0)  # matmul path carries nothing


def test_general_streaming_equals_oneshot_bitexact(gparams):
    """Chunked decode + final flush must be BIT-exact (atol=0) vs one-shot:
    the overlap-recompute window with per-layer boundary masks IS the
    one-shot computation for every emitted sample."""
    total = 11
    codes = _gcodes(total, seed=3)

    one, v, _ = vocoder.decode(gparams, GCFG, codes,
                               vocoder.init_state(GCFG, 1), True)
    one = np.asarray(one)[:, : int(v[0])]
    assert one.shape[1] == total * F

    state = vocoder.init_state(GCFG, 1)
    chunks = []
    for start in range(0, total, 4):
        part = codes[:, start:start + 4]
        wav, valid, state = vocoder.decode(gparams, GCFG, part, state,
                                           start + 4 >= total)
        chunks.append(np.asarray(wav)[:, : int(valid[0])])
    streamed = np.concatenate(chunks, axis=1)
    assert streamed.shape == one.shape
    _assert_ulp_equal(streamed, one)


def test_general_flush_drains_pending(gparams):
    total = 7
    codes = _gcodes(total, seed=4)
    one, v, _ = vocoder.decode(gparams, GCFG, codes,
                               vocoder.init_state(GCFG, 1), True)
    one = np.asarray(one)[:, : int(v[0])]

    state = vocoder.init_state(GCFG, 1)
    w1, v1, state = vocoder.decode(gparams, GCFG, codes, state, False)
    w2, v2, _ = vocoder.flush(gparams, GCFG, state)
    got = np.concatenate([np.asarray(w1)[:, : int(v1[0])],
                          np.asarray(w2)[:, : int(v2[0])]], axis=1)
    _assert_ulp_equal(got, one)


def test_general_short_stream_is_last_first_call(gparams):
    """A stream shorter than the upsampler context, flushed on its first
    call (young + last: both window edges are true stream boundaries)."""
    total = 2                                # < ctx_l + ctx_r
    codes = _gcodes(total, seed=6)
    wav, v, _ = vocoder.decode(gparams, GCFG, codes,
                               vocoder.init_state(GCFG, 1), True)
    assert v.tolist() == [total * F]
    # and in two 1-frame calls
    state = vocoder.init_state(GCFG, 1)
    w1, v1, state = vocoder.decode(gparams, GCFG, codes[:, :1], state, False)
    w2, v2, _ = vocoder.decode(gparams, GCFG, codes[:, 1:], state, True)
    got = np.concatenate([np.asarray(w1)[:, : int(v1[0])],
                          np.asarray(w2)[:, : int(v2[0])]], axis=1)
    _assert_ulp_equal(got, np.asarray(wav)[:, : int(v[0])])


def test_general_per_row_is_last(gparams):
    codes = _gcodes(4, batch=2, seed=5)
    state = vocoder.init_state(GCFG, 2)
    is_last = jnp.asarray([True, False])
    wav, valid, _ = vocoder.decode(gparams, GCFG, codes, state, is_last)
    assert valid.tolist()[0] == 4 * F
    assert valid.tolist()[1] < 4 * F         # withheld lookahead + ctx_r
    solo, vs, _ = vocoder.decode(gparams, GCFG, codes[:1],
                                 vocoder.init_state(GCFG, 1), True)
    # batch-2 vs batch-1 conv kernels round differently; same tolerance as
    # the matmul-path per-row test
    np.testing.assert_allclose(
        np.asarray(wav)[0, : int(valid[0])],
        np.asarray(solo)[0, : int(vs[0])], rtol=1e-4, atol=1e-7)


def test_general_snake_streaming(gparams):
    p = vocoder.init_vocoder(jax.random.key(2), GCFG_SNAKE)
    assert "alpha" in p["up"][0] and "alpha1" in p["up"][0]["res"][0]
    assert "alpha" in p["final"]
    total = 9
    codes = _gcodes(total, seed=7)
    one, v, _ = vocoder.decode(p, GCFG_SNAKE, codes,
                               vocoder.init_state(GCFG_SNAKE, 1), True)
    one = np.asarray(one)[:, : int(v[0])]
    state = vocoder.init_state(GCFG_SNAKE, 1)
    chunks = []
    for start in range(0, total, 4):
        part = codes[:, start:start + 4]
        wav, valid, state = vocoder.decode(p, GCFG_SNAKE, part, state,
                                           start + 4 >= total)
        chunks.append(np.asarray(wav)[:, : int(valid[0])])
    _assert_ulp_equal(np.concatenate(chunks, axis=1), one)


def test_general_gather_and_reset_row(gparams):
    codes = _gcodes(5, batch=3, seed=8)
    state = vocoder.init_state(GCFG, 3)
    _, _, state = vocoder.decode(gparams, GCFG, codes, state, False)
    w_row, v_row, _ = vocoder.flush(gparams, GCFG,
                                    vocoder.gather_row(state, 1))
    state1 = vocoder.init_state(GCFG, 1)
    _, _, state1 = vocoder.decode(gparams, GCFG, codes[1:2], state1, False)
    w_solo, v_solo, _ = vocoder.flush(gparams, GCFG, state1)
    assert v_row.tolist() == v_solo.tolist()
    np.testing.assert_allclose(np.asarray(w_row), np.asarray(w_solo),
                               rtol=1e-4, atol=1e-7)
    # reset_row returns the slot to the stream-start state
    reset = vocoder.reset_row(state, 1)
    assert int(reset.frames_done[1]) == 0
    assert float(jnp.abs(reset.up_hist[1]).max()) == 0.0


def _np_convT(x, wt, b, s, pads):
    """x [Cin,T], wt [Cin,Cout,K] -> [Cout, T*s] (trimmed by pads)."""
    Cin, Cout, K = wt.shape
    T = x.shape[1]
    full = np.zeros((Cout, (T - 1) * s + K))
    for i in range(T):
        full[:, i * s:i * s + K] += np.einsum("c,cok->ok", x[:, i], wt)
    pl, pr = pads
    out = full[:, pl: full.shape[1] - pr]
    return out + b[:, None]


def _np_dconv(x, w, b, d):
    """Symmetric-pad dilated conv: x [Cin,T], w [Cout,Cin,K] -> [Cout,T]."""
    Cout, Cin, K = w.shape
    reach = d * (K - 1)
    pl = reach // 2
    xp = np.concatenate([np.zeros((Cin, pl)), x,
                         np.zeros((Cin, reach - pl))], axis=1)
    T = x.shape[1]
    out = np.zeros((Cout, T))
    for k in range(K):
        out += np.einsum("oi,it->ot", w[:, :, k], xp[:, k * d:k * d + T])
    return out + b[:, None]


def np_general_upsample(params, cfg, lat):
    """Independent one-shot general upsampler: lat [N, hidden] -> wav."""
    p = jax.tree.map(np.asarray, params)

    def act(entry, key, x):
        if cfg.activation != "snake":
            return _np_gelu(x)
        a = entry[key][:, None]
        s = np.sin(a * x)
        return x + s * s / a

    z = lat.T                                     # [C, N]
    pads = vocoder.stage_pads(cfg)
    for i, (stage, (k, s)) in enumerate(zip(
            p["up"], zip(cfg.upsample_kernels, cfg.upsample_factors))):
        z = act(stage, "alpha", z)
        z = _np_convT(z, stage["wt"], stage["b"], s, pads[i])
        for unit, d in zip(stage.get("res", ()), cfg.resblock_dilations):
            y = act(unit, "alpha1", z)
            y = _np_dconv(y, unit["w1"], unit["b1"], d)
            y = act(unit, "alpha2", y)
            y = _np_dconv(y, unit["w2"], unit["b2"], 1)
            z = z + y
    fin = p["final"]
    z = act(fin, "alpha", z)
    z = _np_dconv(z, fin["w"], fin["b"], 1)
    return np.tanh(z)[0]


def test_general_matches_numpy_oracle(gparams):
    """decode() against a from-scratch numpy implementation of the whole
    general pipeline (embed-sum -> convs -> transformer -> post-net ->
    act/ConvTranspose/resunits/final-conv stack)."""
    codes = np.random.default_rng(11).integers(0, GCFG.code_vocab, (6, 16))
    p = jax.tree.map(np.asarray, gparams)
    N = codes.shape[0]
    la, kp, kb = GCFG.lookahead, GCFG.pre_conv_kernel, GCFG.post_conv_kernel

    emb = np.zeros((N, GCFG.embed_dim))
    for q in range(GCFG.num_codebooks):
        emb += p["embed"][q][np.clip(codes[:, q], 0, GCFG.code_vocab - 1)]
    x = np.concatenate([np.zeros((GCFG.embed_dim, kp - 1)), emb.T], axis=1)
    y = _np_gelu(_np_conv_valid(x, p["pre_conv"]["w"], p["pre_conv"]["b"]))
    tcfg = vocoder.transformer_config(GCFG)
    h, _ = np_forward(gparams["transformer"], tcfg, y.T.astype(np.float32),
                      np.arange(N))
    a_in = np.concatenate([np.zeros((GCFG.hidden, la)), h.T,
                           np.zeros((GCFG.hidden, la))], axis=1)
    a = _np_gelu(_np_conv_valid(a_in, p["post_a"]["w"], p["post_a"]["b"]))
    b_in = np.concatenate([np.zeros((GCFG.hidden, kb - 1)), a], axis=1)
    bb = _np_gelu(_np_conv_valid(b_in, p["post_b"]["w"], p["post_b"]["b"]))
    want = np_general_upsample(gparams, GCFG, bb.T)

    wav, valid, _ = vocoder.decode(
        gparams, GCFG, jnp.asarray(codes, jnp.int32)[None],
        vocoder.init_state(GCFG, 1), True)
    got = np.asarray(wav)[0, : int(valid[0])]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
