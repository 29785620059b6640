"""Audio codec encoder + speaker encoder (voice-cloning front-ends).

Implementations of the reference's two ONNX sessions
(`src/models/onnx.rs:82-163`), with architectures DERIVED from the codec
structure the decoder pins down rather than invented freely:

  * AudioEncoder — waveform [N] f32 -> codes [N // 2000, 16]
    (`input_values [1,N]` -> `audio_codes [1, T//2000, 16]`,
    src/models/onnx.rs:97-121). The codec is a residual VQ: the decoder
    reconstructs from a SUM of 16 codebook embeddings (512-d, pinned by
    pre_conv_history [1,512,T]), so the encoder must end in a 16-stage
    RVQ against those same codebooks. Pipeline: strided frame-local
    downsampling stack (kernel == stride: pure matmuls, the mirror image
    of the vocoder's upsampler) -> bidirectional transformer -> 512-d
    latent projection -> greedy residual quantization (distance argmin as
    a matmul).

  * SpeakerEncoder — waveform -> log-mel [F,128] (models/mel.py, the
    hand-rolled librosa-aligned frontend of src/models/onnx.rs:167-320)
    -> conv subsampling -> bidirectional transformer -> attentive
    statistics pooling (weighted mean ++ std, the standard speaker-
    verification head) -> linear to the 2048-d spk_emb consumed by the
    prompt builder (src/tts/prompt.rs:207-222).

Both are optional at engine load, mirroring the reference's `.ok()`
semantics (src/tts/engine.rs:107-120). Converters from torch state dicts
live here (used by tools/convert_weights.py).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..assets import checkpoint
from ..core.config import (AudioEncoderConfig, EngineConfig, MelConfig,
                           SpeakerEncoderConfig)
from . import mel as mel_mod
from .decoder import rms_norm


# ----------------------------------------------------------------- encoder nn
def _init_encoder_stack(key, n_layers, hidden, n_heads, head_dim, ffn,
                        scale=0.02):
    ks = jax.random.split(key, 7)

    def w(k, shape):
        return (scale * jax.random.normal(k, shape)).astype(jnp.float32)

    return {
        "ln1": jnp.ones((n_layers, hidden)),
        "wqkv": w(ks[0], (n_layers, hidden, 3 * n_heads * head_dim)),
        "wo": w(ks[1], (n_layers, n_heads * head_dim, hidden)),
        "ln2": jnp.ones((n_layers, hidden)),
        "w_gate": w(ks[2], (n_layers, hidden, ffn)),
        "w_up": w(ks[3], (n_layers, hidden, ffn)),
        "w_down": w(ks[4], (n_layers, ffn, hidden)),
    }


def _encoder_stack(params, x, n_heads, head_dim, eps):
    """Bidirectional (non-causal) transformer over [B, T, H] via lax.scan."""
    B, T, H = x.shape

    def layer(h, lw):
        a = rms_norm(h, lw["ln1"], eps)
        qkv = (a @ lw["wqkv"]).reshape(B, T, 3, n_heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = jnp.einsum("bsnh,btnh->bnst", q, k) / jnp.sqrt(float(head_dim))
        probs = jax.nn.softmax(scores, axis=-1)
        att = jnp.einsum("bnst,btnh->bsnh", probs, v).reshape(B, T, -1)
        h = h + att @ lw["wo"]
        m = rms_norm(h, lw["ln2"], eps)
        h = h + (jax.nn.silu(m @ lw["w_gate"]) * (m @ lw["w_up"])) @ lw["w_down"]
        return h, None

    x, _ = jax.lax.scan(layer, x, params)
    return x


# ------------------------------------------------------------------------ RVQ
def rvq_encode(latents: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Greedy residual vector quantization.

    latents [T, D]; codebooks [Q, V, D] (== the vocoder's embedding tables:
    the decoder reconstructs from their sum, so encoding is the matching
    stage-wise nearest-neighbour residual search).

    Returns codes [T, Q] int32. Distance argmin per stage is computed as
    argmax(r @ cb^T - ||cb||^2/2) — one [T,D]x[D,V] matmul per stage.
    """
    Q = codebooks.shape[0]
    half_norms = 0.5 * jnp.sum(codebooks.astype(jnp.float32) ** 2, axis=-1)

    def stage(residual, q):
        cb = codebooks[q].astype(jnp.float32)                 # [V, D]
        scores = residual @ cb.T - half_norms[q][None]        # [T, V]
        idx = jnp.argmax(scores, axis=-1).astype(jnp.int32)
        residual = residual - cb[idx]
        return residual, idx

    _, codes = jax.lax.scan(stage, latents.astype(jnp.float32),
                            jnp.arange(Q, dtype=jnp.int32))
    return codes.T                                            # [T, Q]


# -------------------------------------------------------------- audio encoder
def downsample_channels(cfg: AudioEncoderConfig):
    """Mirror of the vocoder's upsampler schedule: 1 -> ... -> hidden."""
    chans = [cfg.hidden]
    c = cfg.hidden
    for _ in cfg.downsample_factors[:-1]:
        c = max(32, c // 2)
        chans.append(c)
    chans.append(1)
    return chans[::-1]                       # [1, ..., hidden]


def init_audio_encoder(key, cfg: AudioEncoderConfig, scale=0.02,
                       codebooks: jax.Array | None = None):
    n_down = len(cfg.downsample_factors)
    ks = jax.random.split(key, 4 + n_down)

    def w(k, shape):
        return (scale * jax.random.normal(k, shape)).astype(jnp.float32)

    chans = downsample_channels(cfg)
    down = []
    for i, s in enumerate(cfg.downsample_factors):
        c_in, c_out = chans[i], chans[i + 1]
        down.append({
            "w": w(ks[4 + i], (s * c_in, c_out)),
            "b": jnp.zeros((c_out,), jnp.float32),
        })
    if codebooks is None:
        codebooks = w(ks[2], (cfg.num_codebooks, cfg.code_vocab,
                              cfg.latent_dim))
    return {
        "down": down,
        "stack": _init_encoder_stack(
            ks[0], cfg.n_layers, cfg.hidden, cfg.n_heads, cfg.head_dim,
            cfg.ffn_dim, scale),
        "final_norm": jnp.ones((cfg.hidden,)),
        "latent_proj": {"w": w(ks[1], (cfg.hidden, cfg.latent_dim)),
                        "b": jnp.zeros((cfg.latent_dim,), jnp.float32)},
        # RVQ codebooks — the same tables the vocoder decodes with
        "codebooks": jnp.asarray(codebooks, jnp.float32),
    }


@functools.partial(jax.jit, static_argnames=("cfg", "n_frames"))
def _audio_encode_jit(params, cfg: AudioEncoderConfig, audio: jax.Array,
                      n_frames: int) -> jax.Array:
    z = audio[: n_frames * cfg.frame_samples].reshape(-1, 1)  # [N, 1]
    for stage, s in zip(params["down"], cfg.downsample_factors):
        c_in = z.shape[-1]
        z = z.reshape(-1, s * c_in) @ stage["w"] + stage["b"]
        z = jax.nn.gelu(z)
    h = z[None]                                               # [1, T, hidden]
    h = _encoder_stack(params["stack"], h, cfg.n_heads, cfg.head_dim,
                       cfg.rms_eps)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    lat = h[0] @ params["latent_proj"]["w"] + params["latent_proj"]["b"]
    return rvq_encode(lat, params["codebooks"])[None]         # [1, T, 16]


class AudioEncoder:
    def __init__(self, params, cfg: AudioEncoderConfig):
        self.params = params
        self.cfg = cfg

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """wav [N] -> flat codes [T*16] int64, T = N // 2000
        (src/models/onnx.rs:97-121)."""
        audio = np.asarray(audio, np.float32)
        n_frames = len(audio) // self.cfg.frame_samples
        if n_frames == 0:
            return np.zeros((0,), np.int64)
        codes = _audio_encode_jit(self.params, self.cfg,
                                  jnp.asarray(audio), n_frames)
        return np.asarray(codes[0]).astype(np.int64).reshape(-1)


# ------------------------------------------------------------ speaker encoder
def init_speaker_encoder(key, cfg: SpeakerEncoderConfig, scale=0.02):
    ks = jax.random.split(key, 6)

    def w(k, shape):
        return (scale * jax.random.normal(k, shape)).astype(jnp.float32)

    subs = []
    c_in = cfg.n_mels
    for i, s in enumerate(cfg.subsample_factors):
        subs.append({"w": w(ks[3 + i], (s * c_in, cfg.hidden)),
                     "b": jnp.zeros((cfg.hidden,), jnp.float32)})
        c_in = cfg.hidden
    return {
        "sub": subs,
        "stack": _init_encoder_stack(
            ks[0], cfg.n_layers, cfg.hidden, cfg.n_heads, cfg.head_dim,
            cfg.ffn_dim, scale),
        "final_norm": jnp.ones((cfg.hidden,)),
        # attentive statistics pooling + output projection
        "attn_w": w(ks[1], (cfg.hidden, 1)),
        "out_proj": {"w": w(ks[2], (2 * cfg.hidden, cfg.out_dim)),
                     "b": jnp.zeros((cfg.out_dim,), jnp.float32)},
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def _speaker_encode_jit(params, cfg: SpeakerEncoderConfig,
                        mels: jax.Array) -> jax.Array:
    z = mels                                                  # [F, n_mels]
    for stage, s in zip(params["sub"], cfg.subsample_factors):
        F_now, C = z.shape
        keep = (F_now // s) * s
        z = z[:keep].reshape(-1, s * C) @ stage["w"] + stage["b"]
        z = jax.nn.gelu(z)
    h = _encoder_stack(params["stack"], z[None], cfg.n_heads, cfg.head_dim,
                       cfg.rms_eps)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)[0]     # [T, hidden]
    # attentive statistics pooling: softmax frame weights -> mean ++ std
    a = jax.nn.softmax((h @ params["attn_w"])[:, 0])          # [T]
    mean = jnp.sum(a[:, None] * h, axis=0)
    var = jnp.sum(a[:, None] * (h - mean) ** 2, axis=0)
    stats = jnp.concatenate([mean, jnp.sqrt(var + 1e-6)])
    return stats @ params["out_proj"]["w"] + params["out_proj"]["b"]


class SpeakerEncoder:
    def __init__(self, params, cfg: SpeakerEncoderConfig,
                 mel_cfg: MelConfig = MelConfig()):
        self.params = params
        self.cfg = cfg
        self.mel_cfg = mel_cfg

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """wav -> mel [F,128] -> spk_emb [out_dim]
        (src/models/onnx.rs:140-163)."""
        mels = mel_mod.compute_mel(np.asarray(audio, np.float32), self.mel_cfg)
        min_frames = int(np.prod(self.cfg.subsample_factors))
        if mels.shape[0] < min_frames:
            return np.zeros((self.cfg.out_dim,), np.float32)
        emb = _speaker_encode_jit(self.params, self.cfg, jnp.asarray(mels))
        return np.asarray(emb, np.float32)


# ------------------------------------------------------------------- loading
def load_encoders(model_dir: str, config: EngineConfig
                  ) -> Tuple[AudioEncoder, SpeakerEncoder]:
    ae_path = os.path.join(model_dir, "audio_encoder.npz")
    se_path = os.path.join(model_dir, "speaker_encoder.npz")
    if not (os.path.exists(ae_path) and os.path.exists(se_path)):
        raise FileNotFoundError(f"encoder checkpoints not found in {model_dir}")
    like_a = jax.eval_shape(
        lambda: init_audio_encoder(jax.random.key(0), config.audio_encoder))
    like_s = jax.eval_shape(
        lambda: init_speaker_encoder(jax.random.key(0), config.speaker_encoder))
    ae = checkpoint.load_pytree(ae_path, like_a)
    se = checkpoint.load_pytree(se_path, like_s)
    return (AudioEncoder(ae, config.audio_encoder),
            SpeakerEncoder(se, config.speaker_encoder, config.mel))


def random_encoders(key, config: EngineConfig, vocoder_params=None
                    ) -> Tuple[AudioEncoder, SpeakerEncoder]:
    """Seeded random encoders; when vocoder params are given, the RVQ
    codebooks are TIED to the vocoder's embedding tables (the real codec's
    structure), making encode/decode a consistent round-trip."""
    k1, k2 = jax.random.split(key)
    cb = None
    if vocoder_params is not None:
        cb = vocoder_params["embed"]
    return (
        AudioEncoder(init_audio_encoder(k1, config.audio_encoder,
                                        codebooks=cb),
                     config.audio_encoder),
        SpeakerEncoder(init_speaker_encoder(k2, config.speaker_encoder),
                       config.speaker_encoder, config.mel),
    )


# ---------------------------------------------------------------- converters
def convert_audio_encoder_state_dict(sd: Dict[str, np.ndarray],
                                     cfg: AudioEncoderConfig | None = None
                                     ) -> Dict[str, Any]:
    """Torch state dict -> audio-encoder pytree (see tools/convert_weights
    for the naming convention; strided Conv1d [out, in, k] with k == stride
    becomes the matmul form [k*in, out])."""
    cfg = cfg or AudioEncoderConfig()

    def T(name):
        return np.ascontiguousarray(np.asarray(sd[name], np.float32).T)

    def raw(name):
        return np.asarray(sd[name], np.float32)

    down = []
    for i, s in enumerate(cfg.downsample_factors):
        w = raw(f"encoder.downsample.{i}.weight")    # [out, in, k], k == s
        c_out, c_in, k = w.shape
        assert k == s, f"downsample stage {i}: kernel {k} != stride {s}"
        # y[t, o] = sum_{j,i} x[t*s+j, i] w[o, i, j] -> w2[(j*c_in)+i, o]
        down.append({
            "w": np.ascontiguousarray(
                w.transpose(2, 1, 0).reshape(s * c_in, c_out)),
            "b": raw(f"encoder.downsample.{i}.bias"),
        })
    stack = _convert_stack_sd(sd, "encoder.layers", cfg.n_layers)
    return {
        "down": down,
        "stack": stack,
        "final_norm": raw("encoder.norm.weight"),
        "latent_proj": {"w": T("encoder.latent_proj.weight"),
                        "b": raw("encoder.latent_proj.bias")},
        "codebooks": np.stack([raw(f"quantizer.codebooks.{q}.weight")
                               for q in range(cfg.num_codebooks)]),
    }


def convert_speaker_encoder_state_dict(sd: Dict[str, np.ndarray],
                                       cfg: SpeakerEncoderConfig | None = None
                                       ) -> Dict[str, Any]:
    cfg = cfg or SpeakerEncoderConfig()

    def T(name):
        return np.ascontiguousarray(np.asarray(sd[name], np.float32).T)

    def raw(name):
        return np.asarray(sd[name], np.float32)

    subs = []
    for i, s in enumerate(cfg.subsample_factors):
        w = raw(f"encoder.subsample.{i}.weight")     # [out, in, k], k == s
        c_out, c_in, k = w.shape
        assert k == s
        subs.append({
            "w": np.ascontiguousarray(
                w.transpose(2, 1, 0).reshape(s * c_in, c_out)),
            "b": raw(f"encoder.subsample.{i}.bias"),
        })
    stack = _convert_stack_sd(sd, "encoder.layers", cfg.n_layers)
    return {
        "sub": subs,
        "stack": stack,
        "final_norm": raw("encoder.norm.weight"),
        "attn_w": T("pooling.attention.weight"),
        "out_proj": {"w": T("projection.weight"),
                     "b": raw("projection.bias")},
    }


def _convert_stack_sd(sd, prefix, n_layers):
    """Bidirectional encoder stack: fused qkv + separate gate/up."""

    def T(name):
        return np.ascontiguousarray(np.asarray(sd[name], np.float32).T)

    def raw(name):
        return np.asarray(sd[name], np.float32)

    layers: Dict[str, list] = {k: [] for k in (
        "ln1", "wqkv", "wo", "ln2", "w_gate", "w_up", "w_down")}
    for i in range(n_layers):
        p = f"{prefix}.{i}."
        layers["ln1"].append(raw(p + "input_layernorm.weight"))
        layers["wqkv"].append(np.concatenate(
            [T(p + "self_attn.q_proj.weight"),
             T(p + "self_attn.k_proj.weight"),
             T(p + "self_attn.v_proj.weight")], axis=1))
        layers["wo"].append(T(p + "self_attn.o_proj.weight"))
        layers["ln2"].append(raw(p + "post_attention_layernorm.weight"))
        layers["w_gate"].append(T(p + "mlp.gate_proj.weight"))
        layers["w_up"].append(T(p + "mlp.up_proj.weight"))
        layers["w_down"].append(T(p + "mlp.down_proj.weight"))
    return {k: np.stack(v) for k, v in layers.items()}


def export_audio_encoder_state_dict(params, cfg: AudioEncoderConfig | None
                                    = None) -> Dict[str, np.ndarray]:
    """Inverse of convert_audio_encoder_state_dict (round-trip testing)."""
    cfg = cfg or AudioEncoderConfig()
    sd: Dict[str, np.ndarray] = {}
    for i, s in enumerate(cfg.downsample_factors):
        w2 = np.asarray(params["down"][i]["w"])      # [s*c_in, c_out]
        c_out = w2.shape[1]
        c_in = w2.shape[0] // s
        sd[f"encoder.downsample.{i}.weight"] = np.ascontiguousarray(
            w2.reshape(s, c_in, c_out).transpose(2, 1, 0))
        sd[f"encoder.downsample.{i}.bias"] = np.asarray(
            params["down"][i]["b"])
    _export_stack_sd(sd, "encoder.layers", params["stack"])
    sd["encoder.norm.weight"] = np.asarray(params["final_norm"])
    sd["encoder.latent_proj.weight"] = np.asarray(
        params["latent_proj"]["w"]).T
    sd["encoder.latent_proj.bias"] = np.asarray(params["latent_proj"]["b"])
    for q in range(cfg.num_codebooks):
        sd[f"quantizer.codebooks.{q}.weight"] = np.asarray(
            params["codebooks"][q])
    return sd


def export_speaker_encoder_state_dict(params, cfg: SpeakerEncoderConfig |
                                      None = None) -> Dict[str, np.ndarray]:
    cfg = cfg or SpeakerEncoderConfig()
    sd: Dict[str, np.ndarray] = {}
    for i, s in enumerate(cfg.subsample_factors):
        w2 = np.asarray(params["sub"][i]["w"])
        c_out = w2.shape[1]
        c_in = w2.shape[0] // s
        sd[f"encoder.subsample.{i}.weight"] = np.ascontiguousarray(
            w2.reshape(s, c_in, c_out).transpose(2, 1, 0))
        sd[f"encoder.subsample.{i}.bias"] = np.asarray(params["sub"][i]["b"])
    _export_stack_sd(sd, "encoder.layers", params["stack"])
    sd["encoder.norm.weight"] = np.asarray(params["final_norm"])
    sd["pooling.attention.weight"] = np.asarray(params["attn_w"]).T
    sd["projection.weight"] = np.asarray(params["out_proj"]["w"]).T
    sd["projection.bias"] = np.asarray(params["out_proj"]["b"])
    return sd


def _export_stack_sd(sd, prefix, stack):
    L = stack["ln1"].shape[0]
    width = stack["wqkv"].shape[-1] // 3
    for i in range(L):
        p = f"{prefix}.{i}."
        sd[p + "input_layernorm.weight"] = np.asarray(stack["ln1"][i])
        wqkv = np.asarray(stack["wqkv"][i])
        sd[p + "self_attn.q_proj.weight"] = wqkv[:, :width].T
        sd[p + "self_attn.k_proj.weight"] = wqkv[:, width:2 * width].T
        sd[p + "self_attn.v_proj.weight"] = wqkv[:, 2 * width:].T
        sd[p + "self_attn.o_proj.weight"] = np.asarray(stack["wo"][i]).T
        sd[p + "post_attention_layernorm.weight"] = np.asarray(
            stack["ln2"][i])
        sd[p + "mlp.gate_proj.weight"] = np.asarray(stack["w_gate"][i]).T
        sd[p + "mlp.up_proj.weight"] = np.asarray(stack["w_up"][i]).T
        sd[p + "mlp.down_proj.weight"] = np.asarray(stack["w_down"][i]).T
