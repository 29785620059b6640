"""Streaming vocoder: 16-codebook frames -> 24 kHz waveform.

Implementation of the reference's stateful ONNX codec decoder
(`src/models/onnx.rs:324-496`). The architecture is DERIVED from the only
ground truth available in this container — the graph's carried-state
signature and call contract — not invented freely:

  carried state (src/models/onnx.rs:461-496)          what it pins
  ------------------------------------------------   ----------------------
  pre_conv_history  [1, 512, T]                       a conv over a 512-ch
                                                      sequence BEFORE the
                                                      1024-d trunk => code
                                                      embeddings are 512-d,
                                                      summed over the 16
                                                      codebooks (RVQ decode)
  past_key/value_0..7  [1, 16, T, 64]                 an 8-layer, 16-head,
                                                      64-head-dim (=1024-d)
                                                      causal transformer with
                                                      appended KV
  latent_buffer  [1, 1024, T]                         1024-ch latents carried
                                                      ACROSS calls => the
                                                      post-trunk conv needs
                                                      future latents (lookahead)
  conv_history   [1, 1024, T]                         a second, causal 1024-ch
                                                      conv stage
  is_last [1], valid_samples (variable!)              a flush + a decode
  (src/models/onnx.rs:342-458, 398-405)               delay: non-final calls
                                                      cannot emit the last
                                                      `lookahead` frames

Pipeline (all shapes [B, ...]; reference is B=1):

  codes [B,N,16] --embed-sum--> [B,N,512]
    --causal pre-conv (K=3, history=pre_conv_history)--> [B,N,1024]
    --8L/16H/64hd causal transformer (KV cache)--> latents [B,N,1024]
    --CENTERED conv (K=2*LA+1, left ctx + LA-frame lookahead;
      pending latents = latent_buffer)--> [B,N+LA,1024]
    --causal conv (K=3, history=conv_history)--> [B,N+LA,1024]
    --frame-local transposed-conv stack (strides 5,5,5,4,4 == 2000x,
      kernel==stride => pure matmuls, no carried state)--> wav

`valid_samples` falls out of the lookahead: a non-final call emits
N - max(LA - frames_done, 0) frames (the first call withholds LA frames;
later calls emit exactly N); `is_last` zero-pads the lookahead window and
flushes the remaining LA frames — identically to zero-padded one-shot
decoding, so chunked output is BIT-EXACT vs one-shot (tested). `is_last` may
be per-row ([B] bool) for continuous batching; `flush()` drains a stream
that ends between calls.

Weights load from a converted checkpoint (tools/convert_weights.py has the
torch-state-dict name map); seeded random init serves tests/benchmarks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..core.config import PredictorConfig, VocoderConfig
from . import decoder


def transformer_config(cfg: VocoderConfig) -> PredictorConfig:
    """Express the vocoder transformer through the shared decoder module."""
    return PredictorConfig(
        hidden=cfg.hidden,
        n_layers=cfg.n_layers,
        n_q_heads=cfg.n_heads,
        n_kv_heads=cfg.n_heads,
        head_dim=cfg.head_dim,
        ffn_dim=cfg.ffn_dim,
        vocab=8,                       # head unused (with_logits=False)
        max_seq=cfg.max_frames,
        mrope_sections=(cfg.head_dim // 2, 0, 0, 0),
        dtype=cfg.dtype,
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class VocoderState:
    """Carried streaming state (fixed shapes; field set == the reference's
    carried tensors, src/models/onnx.rs:461-496 — `frames_done` stands in
    for the reference's growing time dimension)."""

    pre_conv_history: jax.Array   # [B, embed_dim, pre_k-1]
    latent_buffer: jax.Array      # [B, hidden, 2*lookahead]
    conv_history: jax.Array       # [B, hidden, post_k-1]
    kv: Dict[str, jax.Array]      # decoder cache [L, B, H, max_frames, hd]
    frames_done: jax.Array        # [B] int32 (per row: continuous batching)
    # general-upsampler rolling latent window ([B, hidden, ctx_l+ctx_r];
    # width 0 on the kernel==stride matmul path)
    up_hist: jax.Array

    def tree_flatten(self):
        return (
            (self.pre_conv_history, self.latent_buffer, self.conv_history,
             self.kv, self.frames_done, self.up_hist),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def init_state(cfg: VocoderConfig, batch: int,
               frames: int | None = None) -> VocoderState:
    """Zero state == the reference's empty (length-0) buffers
    (src/models/onnx.rs:474-495): zero-padding at stream start.

    `frames` bounds the transformer KV extent when the total frame count
    is known up front (the one-shot path inside generate_audio): the
    dense attention then scans the real extent instead of max_frames
    slots. Streaming callers keep the full window.
    """
    tcfg = transformer_config(cfg)
    if frames is not None:
        import dataclasses
        tcfg = dataclasses.replace(
            tcfg, max_seq=max(8, min(tcfg.max_seq, frames)))
    return VocoderState(
        pre_conv_history=jnp.zeros(
            (batch, cfg.embed_dim, cfg.pre_conv_kernel - 1), jnp.float32),
        latent_buffer=jnp.zeros(
            (batch, cfg.hidden, 2 * cfg.lookahead), jnp.float32),
        conv_history=jnp.zeros(
            (batch, cfg.hidden, cfg.post_conv_kernel - 1), jnp.float32),
        # KV follows cfg.dtype: f32 by default (ONNX-parity), bf16 when the
        # transformer trunk runs bf16 (see with_dtype)
        kv=decoder.init_kv_cache(tcfg, batch),
        frames_done=jnp.zeros((batch,), jnp.int32),
        up_hist=jnp.zeros((batch, cfg.hidden, sum(up_context(cfg))),
                          jnp.float32),
    )


def with_dtype(params: Dict[str, Any], cfg: VocoderConfig) -> Dict[str, Any]:
    """Cast the transformer trunk to cfg.dtype.

    The trunk carries ~90% of the vocoder FLOPs (8L x 1024h x 4096F over
    every frame); bf16 runs it on the tensor cores at the bf16 rate (pair
    with dataclasses.replace(cfg, dtype='bfloat16')).
    The conv stacks / upsampler / carried conv state stay f32: they are a
    small FLOP share and keep the streaming-contract math unchanged."""
    dt = jnp.dtype(cfg.dtype)
    if dt == jnp.float32:
        return params
    tr = jax.tree.map(
        lambda a: a.astype(dt) if a.dtype == jnp.float32 else a,
        params["transformer"])
    return dict(params, transformer=tr)


def init_vocoder(key: jax.Array, cfg: VocoderConfig,
                 scale: float = 0.02) -> Dict[str, Any]:
    n_up = len(cfg.upsample_factors)
    n_res = len(cfg.resblock_dilations)
    ks = iter(jax.random.split(key, 8 + n_up * (2 * n_res + 1)))

    def w(shape):
        return (scale * jax.random.normal(next(ks), shape)).astype(
            jnp.float32)

    snake = cfg.activation == "snake"

    def alpha(c, name="alpha"):
        # snake alphas init to 1.0 (checkpoints overwrite); per channel
        return {name: jnp.ones((c,), jnp.float32)} if snake else {}

    n = len(cfg.upsample_factors)
    if cfg.general_upsampler:
        # DAC/BigVGAN-family stage: act -> ConvTranspose(k != s) ->
        # residual dilated units; final act -> Conv -> tanh head
        chans = up_channels(cfg)
        up = []
        for i, (k_, s_) in enumerate(zip(cfg.upsample_kernels,
                                         cfg.upsample_factors)):
            c_in, c_out = chans[i], chans[i + 1]
            entry = {"wt": w((c_in, c_out, k_)),     # torch IOH layout
                     "b": jnp.zeros((c_out,), jnp.float32),
                     **alpha(c_in)}
            res = []
            for _d in cfg.resblock_dilations:
                kr = cfg.resblock_kernel
                res.append({
                    "w1": w((c_out, c_out, kr)),
                    "b1": jnp.zeros((c_out,), jnp.float32),
                    "w2": w((c_out, c_out, 1)),
                    "b2": jnp.zeros((c_out,), jnp.float32),
                    **alpha(c_out, "alpha1"), **alpha(c_out, "alpha2"),
                })
            if res:
                entry["res"] = res
            up.append(entry)
        extra = {"final": {"w": w((1, chans[-1], cfg.final_conv_kernel)),
                           "b": jnp.zeros((1,), jnp.float32),
                           **alpha(chans[-1])}}
    else:
        chans = _upsample_channels(cfg)
        up = []
        for i, s in enumerate(cfg.upsample_factors):
            c_in, c_out = chans[i], chans[i + 1]
            up.append({
                "w": w((c_in, s * c_out)),
                "b": jnp.zeros((s * c_out,), jnp.float32),
                # last stage is tanh (waveform head) in both activation modes
                **(alpha(c_out) if i < n - 1 else {}),
            })
        extra = {}
    la = cfg.lookahead
    return {
        **extra,
        "embed": w((cfg.num_codebooks, cfg.code_vocab, cfg.embed_dim)),
        "pre_conv": {
            "w": w((cfg.hidden, cfg.embed_dim, cfg.pre_conv_kernel)),
            "b": jnp.zeros((cfg.hidden,), jnp.float32),
            **alpha(cfg.hidden),
        },
        "transformer": decoder.init_decoder(next(ks), transformer_config(cfg),
                                            scale),
        "post_a": {   # centered conv: LA left context + LA lookahead
            "w": w((cfg.hidden, cfg.hidden, 2 * la + 1)),
            "b": jnp.zeros((cfg.hidden,), jnp.float32),
            **alpha(cfg.hidden),
        },
        "post_b": {   # causal conv
            "w": w((cfg.hidden, cfg.hidden, cfg.post_conv_kernel)),
            "b": jnp.zeros((cfg.hidden,), jnp.float32),
            **alpha(cfg.hidden),
        },
        "up": up,
    }


def _upsample_channels(cfg: VocoderConfig):
    """Channel schedule 1024 -> ... -> 1, halving per stage (floor 32)."""
    chans = [cfg.hidden]
    c = cfg.hidden
    for _ in cfg.upsample_factors[:-1]:
        c = max(32, c // 2)
        chans.append(c)
    chans.append(1)
    return chans


def _conv1d(x: jax.Array, w: jax.Array, b: jax.Array) -> jax.Array:
    """VALID conv, channels-first: x [B,Cin,T], w [Cout,Cin,K]."""
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
    ) + b[None, :, None]


# ------------------------------------------------- general upsampler family
# BigVGAN/DAC-lineage head: per-stage ConvTranspose with kernel != stride
# (overlap-add across frame boundaries) followed by residual dilated conv
# units, then a final output conv. Streamed by OVERLAP-RECOMPUTE: the stack
# is a time-invariant map with a finite receptive field, so each decode call
# runs it on [rolling latent history | new latents] and emits only the
# samples that are (a) outside the corrupt left edge of the window and
# (b) independent of future latents. Per-layer boundary masks zero every
# position outside the true stream extent at that layer's rate, which makes
# the window computation EXACTLY the one-shot computation for the emitted
# region — including stream start, per-row is_last flush, and short streams.


def stage_pads(cfg: VocoderConfig):
    """Per-stage (left, right) output trims; left + right == kernel - stride
    keeps output length == T * stride (ONNX ConvTranspose pads)."""
    out = []
    for i, (k, s) in enumerate(zip(cfg.upsample_kernels,
                                   cfg.upsample_factors)):
        p = (cfg.upsample_pads[i] if cfg.upsample_pads is not None
             else (k - s + 1) // 2)
        out.append((p, k - s - p))
    return out


def up_channels(cfg: VocoderConfig):
    """General-path channel schedule: hidden halving per stage (floor 32)
    unless cfg.upsample_channels pins it; the final conv maps to 1."""
    if cfg.upsample_channels is not None:
        return [cfg.hidden, *cfg.upsample_channels]
    chans = [cfg.hidden]
    for _ in cfg.upsample_factors:
        chans.append(max(32, chans[-1] // 2))
    return chans


@functools.lru_cache(maxsize=None)
def up_context(cfg: VocoderConfig):
    """(ctx_l, ctx_r) in latent frames for the general upsampler.

    Composes the forward influence interval of one latent frame through the
    stack: a latent at index i influences output samples [i*S + lo,
    i*S + hi]. A sample therefore needs latents up to ceil(hi/S) frames
    back (left context) and up to ceil(-lo/S) frames ahead (lookahead /
    emission delay). (0, 0) on the kernel==stride matmul path."""
    if not cfg.general_upsampler:
        return (0, 0)
    lo = hi = 0
    kr = cfg.resblock_kernel
    for (k, s), (pl, _pr) in zip(
            zip(cfg.upsample_kernels, cfg.upsample_factors),
            stage_pads(cfg)):
        lo, hi = lo * s - pl, hi * s + (k - 1 - pl)
        for d in cfg.resblock_dilations:
            reach = d * (kr - 1)
            pl_r = reach // 2
            lo, hi = lo - (reach - pl_r), hi + pl_r
    kf = cfg.final_conv_kernel
    pf = (kf - 1) // 2
    lo, hi = lo - (kf - 1 - pf), hi + pf
    S = cfg.frame_samples
    return (-(-max(hi, 0) // S), -(-max(-lo, 0) // S))


def _site_act(cfg: VocoderConfig, entry: Dict[str, Any], key: str,
              x: jax.Array) -> jax.Array:
    """Channels-first activation at a named snake-alpha site."""
    if cfg.activation != "snake":
        return jax.nn.gelu(x)
    a = entry[key][None, :, None]
    s = jnp.sin(a * x)
    return x + s * s / a


def _conv_transpose1d(x: jax.Array, wt: jax.Array, b: jax.Array,
                      stride: int, pads) -> jax.Array:
    """ONNX/torch ConvTranspose1d: x [B,Cin,T], wt [Cin,Cout,K] ->
    [B,Cout,T*stride] (output trimmed by pads). Expressed as an
    lhs-dilated correlation with the flipped, transposed kernel."""
    k = wt.shape[-1]
    pl, pr = pads
    w = jnp.flip(jnp.swapaxes(wt, 0, 1), axis=-1)       # [Cout, Cin, K]
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding=[(k - 1 - pl, k - 1 - pr)],
        lhs_dilation=(stride,),
        dimension_numbers=("NCH", "OIH", "NCH"))
    return y + b[None, :, None]


def _dilated_conv1d(x: jax.Array, w: jax.Array, b: jax.Array,
                    dilation: int) -> jax.Array:
    """Symmetrically padded dilated conv (length-preserving)."""
    reach = dilation * (w.shape[-1] - 1)
    pl = reach // 2
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding=[(pl, reach - pl)],
        rhs_dilation=(dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"))
    return y + b[None, :, None]


def _up_stack_general(params, cfg: VocoderConfig, window: jax.Array,
                      g0: jax.Array, n_total: jax.Array) -> jax.Array:
    """One-shot-exact window evaluation of the general upsampler.

    window  [B, hidden, W] latents; column j is global latent g0[b] + j
    (g0 may be negative near stream start — those columns are pre-stream).
    n_total [B] is the stream's total latent extent for the right-side
    mask (for non-final rows the region beyond it is withheld anyway).
    Returns the full window waveform [B, W * frame_samples]; the caller
    emits only the provably-clean sample range.
    """

    def mask(z, rate):
        pos = g0[:, None] * rate + jnp.arange(z.shape[-1],
                                              dtype=jnp.int32)[None]
        ok = (pos >= 0) & (pos < n_total[:, None] * rate)
        return jnp.where(ok[:, None, :], z, 0.0)

    rate = 1
    z = mask(window, rate)
    for stage, (k, s), pads in zip(params["up"],
                                   zip(cfg.upsample_kernels,
                                       cfg.upsample_factors),
                                   stage_pads(cfg)):
        z = _site_act(cfg, stage, "alpha", z)
        z = _conv_transpose1d(z, stage["wt"], stage["b"], s, pads)
        rate *= s
        z = mask(z, rate)
        for unit, d in zip(stage.get("res", ()), cfg.resblock_dilations):
            y = _site_act(cfg, unit, "alpha1", z)
            y = _dilated_conv1d(y, unit["w1"], unit["b1"], d)
            y = _site_act(cfg, unit, "alpha2", y)
            y = _conv1d(y, unit["w2"], unit["b2"])
            z = mask(z + y, rate)
    fin = params["final"]
    z = _site_act(cfg, fin, "alpha", z)
    kf = cfg.final_conv_kernel
    pf = (kf - 1) // 2
    z = jax.lax.conv_general_dilated(
        z, fin["w"], window_strides=(1,), padding=[(pf, kf - 1 - pf)],
        dimension_numbers=("NCH", "OIH", "NCH")) + fin["b"][None, :, None]
    return jnp.tanh(z)[:, 0, :]


def _act(cfg: VocoderConfig, entry: Dict[str, Any], x: jax.Array,
         channel_axis: int) -> jax.Array:
    """Conv-stack activation: gelu (derived default) or per-channel snake
    x + sin^2(alpha*x)/alpha (zero-preserving, like gelu, so the zero-pad
    stream-start semantics are unchanged)."""
    if cfg.activation != "snake":
        return jax.nn.gelu(x)
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    a = entry["alpha"].reshape(shape)
    s = jnp.sin(a * x)
    return x + s * s / a


def _upsample(params, cfg: VocoderConfig, lat: jax.Array) -> jax.Array:
    """Frame-local upsampler: [B, M, hidden] -> [B, M*2000] waveform.

    Each stage is a transposed conv with kernel == stride, i.e. a single
    matmul [.., C_in] @ [C_in, s*C_out] followed by a reshape that
    interleaves the s output positions — the whole 2000x upsampling runs on
    matmuls with zero HBM-bound conv windows and zero carried state."""
    B, M, _ = lat.shape
    z = lat
    n = len(params["up"])
    for i, (stage, s) in enumerate(zip(params["up"], cfg.upsample_factors)):
        z = z @ stage["w"] + stage["b"]              # [B, T, s*C_out]
        c_out = stage["w"].shape[1] // s
        z = z.reshape(B, z.shape[1] * s, c_out)
        z = jnp.tanh(z) if i == n - 1 else _act(cfg, stage, z, 2)
    return z[..., 0]                                 # [B, M*2000]


def _post_stage(
    params, cfg: VocoderConfig,
    h_new: jax.Array,            # [B, N, hidden] new transformer latents
    state: VocoderState,
    is_last: jax.Array,          # [B] int32 (0/1)
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Lookahead post-net + upsampler shared by decode() and flush().

    Returns (wav, valid [B], new_latent_buffer, new_conv_hist, new_up_hist).
    wav is [B,(N+LA)*F] on the matmul path, [B,(N+LA+ctx_r)*F] on the
    general path (emission lags a further ctx_r frames there).
    """
    B, N, H = h_new.shape
    la = cfg.lookahead
    kb = cfg.post_conv_kernel
    fd = state.frames_done                                    # [B]

    hc = jnp.swapaxes(h_new, 1, 2)                            # [B, H, N]
    # centered conv over [pending(2LA) | new(N) | zero lookahead(LA)]:
    # VALID K=2LA+1 -> N+LA outputs at global frame indices fd-LA .. fd+N-1
    a_in = jnp.concatenate(
        [state.latent_buffer, hc, jnp.zeros((B, H, la), jnp.float32)],
        axis=-1)
    a_out = _act(cfg, params["post_a"],
                 _conv1d(a_in, params["post_a"]["w"],
                         params["post_a"]["b"]), 1)           # [B,H,N+LA]
    # zero outputs at negative global indices: they are artifacts of the
    # rolling window at stream start — one-shot decoding has no such
    # positions, and conv_b's left context there must be the zero pad
    g = (fd[:, None] - la) + jnp.arange(N + la, dtype=jnp.int32)[None]
    a_out = jnp.where((g >= 0)[:, None, :], a_out, 0.0)

    b_in = jnp.concatenate([state.conv_history, a_out], axis=-1)
    b_out = _act(cfg, params["post_b"],
                 _conv1d(b_in, params["post_b"]["w"],
                         params["post_b"]["b"]), 1)           # [B,H,N+LA]

    # per-row left-alignment: computed outputs start at global fd-LA, but
    # emission starts at max(fd-LA, 0) — shift off the first
    # max(LA-fd, 0) spurious rows (nonzero only near stream start)
    shift = jnp.clip(la - fd, 0, la)                          # [B]
    lat = jnp.swapaxes(b_out, 1, 2)                           # [B, N+LA, H]
    idx = (jnp.arange(N + la, dtype=jnp.int32)[None] + shift[:, None]) \
        % (N + la)
    lat = jnp.take_along_axis(lat, idx[:, :, None], axis=1)

    # finalized latents this call: everything beyond what previous calls
    # finalized; final calls flush the LA-frame lookahead window
    emitted_before = jnp.maximum(fd - la, 0)
    total = fd + N
    fin_total = jnp.where(is_last > 0, total, jnp.maximum(total - la, 0))
    emit_now = fin_total - emitted_before
    emit_now = jnp.maximum(emit_now, 0)

    if not cfg.general_upsampler:
        # frame-local matmul path: every finalized latent maps to exactly
        # its own 2000 samples, so emission == finalization
        wav = _upsample(params, cfg, lat)                     # [B,(N+LA)*F]
        valid = emit_now * cfg.frame_samples                  # [B]
        new_up_hist = state.up_hist
    else:
        # overlap-recompute streaming (see the general-upsampler block
        # above): evaluate on [rolling history | newly finalized latents],
        # emit the clean range, carry the last ctx_l+ctx_r latents
        S = cfg.frame_samples
        ctx_l, ctx_r = up_context(cfg)
        C = ctx_l + ctx_r
        latT = jnp.swapaxes(lat, 1, 2)                        # [B,H,N+LA]
        window = jnp.concatenate([state.up_hist, latT], axis=-1)
        g0 = emitted_before - C                               # [B]
        wav_full = _up_stack_general(params, cfg, window, g0, fin_total)
        prev_emit = jnp.maximum(emitted_before - ctx_r, 0)
        emit_end = jnp.where(is_last > 0, fin_total,
                             jnp.maximum(fin_total - ctx_r, 0))
        emit_cnt = jnp.maximum(emit_end - prev_emit, 0)
        out_w = (N + la + ctx_r) * S
        idx = (prev_emit - g0)[:, None] * S \
            + jnp.arange(out_w, dtype=jnp.int32)[None]
        wav = jnp.take_along_axis(
            wav_full, jnp.clip(idx, 0, wav_full.shape[1] - 1), axis=1)
        wav = jnp.where(
            jnp.arange(out_w, dtype=jnp.int32)[None]
            < (emit_cnt * S)[:, None], wav, 0.0)
        valid = emit_cnt * S
        hidx = jnp.arange(C, dtype=jnp.int32)[None] + emit_now[:, None]
        new_up_hist = jnp.take_along_axis(window, hidx[:, None, :], axis=2) \
            if C > 0 else state.up_hist

    # pending window: last 2LA latents fed so far (zero-left-padded)
    new_latbuf = jnp.concatenate([state.latent_buffer, hc],
                                 axis=-1)[..., -(2 * la):] if la > 0 \
        else state.latent_buffer
    # causal history: last K_b-1 REAL (non-flush) masked conv_a outputs
    hist_src = jnp.concatenate([state.conv_history, a_out[..., :N]], axis=-1)
    new_hist = hist_src[..., -(kb - 1):] if kb > 1 else state.conv_history
    return wav, valid, new_latbuf, new_hist, new_up_hist


@functools.partial(jax.jit, static_argnames=("cfg",))
def decode(
    params: Dict[str, Any],
    cfg: VocoderConfig,
    codes: jax.Array,            # [B, N, 16] int32
    state: VocoderState,
    is_last: jax.Array | bool = False,
) -> Tuple[jax.Array, jax.Array, VocoderState]:
    """Decode N frames against carried state.

    Returns (wav [B, (N+lookahead)*2000], valid_samples [B], new state) —
    callers consume wav[:, :valid] exactly like the reference trims to
    `valid_samples` (src/models/onnx.rs:398-405). `is_last` (scalar or [B])
    flushes the lookahead window.
    """
    B, N, Q = codes.shape
    if Q != cfg.num_codebooks:
        raise ValueError(
            f"codes must have {cfg.num_codebooks} codebooks, got {Q}")
    codes = jnp.clip(codes, 0, cfg.code_vocab - 1)
    last_vec = jnp.broadcast_to(
        jnp.asarray(is_last, jnp.int32).astype(jnp.int32), (B,))

    # 1. codebook embedding sum (RVQ decode) -> [B, N, embed_dim]
    q_idx = jnp.arange(Q, dtype=jnp.int32)
    emb = params["embed"][q_idx[None, None], codes]           # [B, N, 16, E]
    x = jnp.sum(emb, axis=2)

    # 2. causal pre-conv over frames (channels-first)
    xc = jnp.swapaxes(x, 1, 2)                                # [B, E, N]
    pre_in = jnp.concatenate([state.pre_conv_history, xc], axis=-1)
    y = _act(cfg, params["pre_conv"],
             _conv1d(pre_in, params["pre_conv"]["w"],
                     params["pre_conv"]["b"]), 1)
    kp = cfg.pre_conv_kernel
    new_pre = pre_in[..., -(kp - 1):] if kp > 1 else state.pre_conv_history

    # 3. transformer with carried KV (global positions = frames_done + i);
    # the trunk runs in cfg.dtype (f32 default; bf16 via with_dtype)
    tcfg = transformer_config(cfg)
    h_in = jnp.swapaxes(y, 1, 2).astype(jnp.dtype(cfg.dtype))  # [B,N,hidden]
    pos = state.frames_done[:, None] + jnp.arange(N, dtype=jnp.int32)[None]
    h, _, kv = decoder.forward(
        params["transformer"], tcfg, h_in, pos, state.kv,
        state.frames_done, with_logits=False,
    )

    # 4. lookahead post-net + upsampler (matmul or general streaming path)
    wav, valid, new_latbuf, new_hist, new_up = _post_stage(
        params, cfg, h.astype(jnp.float32), state, last_vec)

    new_state = VocoderState(
        pre_conv_history=new_pre,
        latent_buffer=new_latbuf,
        conv_history=new_hist,
        kv=kv,
        frames_done=state.frames_done + N,
        up_hist=new_up,
    )
    return wav, valid, new_state


@functools.partial(jax.jit, static_argnames=("cfg",))
def flush(
    params: Dict[str, Any],
    cfg: VocoderConfig,
    state: VocoderState,
) -> Tuple[jax.Array, jax.Array, VocoderState]:
    """Drain the lookahead window with no new frames (the N=0 `is_last`
    call): returns (wav [B, lookahead*2000], valid [B], dead state). Used
    when a stream ends between batched decode calls (serving)."""
    B = state.frames_done.shape[0]
    h0 = jnp.zeros((B, 0, cfg.hidden), jnp.float32)
    wav, valid, new_latbuf, new_hist, new_up = _post_stage(
        params, cfg, h0, state, jnp.ones((B,), jnp.int32))
    new_state = VocoderState(
        pre_conv_history=state.pre_conv_history,
        latent_buffer=new_latbuf,
        conv_history=new_hist,
        kv=state.kv,
        frames_done=state.frames_done,
        up_hist=new_up,
    )
    return wav, valid, new_state


def gather_row(state: VocoderState, row: int) -> VocoderState:
    """Extract one batch row as a B=1 state (serving flush-on-completion)."""
    return VocoderState(
        pre_conv_history=state.pre_conv_history[row:row + 1],
        latent_buffer=state.latent_buffer[row:row + 1],
        conv_history=state.conv_history[row:row + 1],
        kv={k: v[:, row:row + 1] for k, v in state.kv.items()},
        frames_done=state.frames_done[row:row + 1],
        up_hist=state.up_hist[row:row + 1],
    )


def reset_row(state: VocoderState, row: int) -> VocoderState:
    """Zero one batch row in place (serving slot reuse on admission)."""

    def zero_row(x):
        return x.at[row].set(jnp.zeros_like(x[row]))

    return VocoderState(
        pre_conv_history=zero_row(state.pre_conv_history),
        latent_buffer=zero_row(state.latent_buffer),
        conv_history=zero_row(state.conv_history),
        kv={k: v.at[:, row].set(0) for k, v in state.kv.items()},
        frames_done=state.frames_done.at[row].set(0),
        up_hist=zero_row(state.up_hist),
    )
