"""Int8/int4 weight quantization and the weight-only quantized matmul.

Counterpart of the reference's quantized-GGUF support (Q5_K_M / Q8_0 / Q4_K
decoded inside llama.cpp, `src/download.rs:55-101`): weights are stored
int8 or packed int4 and widened to the activation dtype right before the
dot, so the dot itself runs on the tensor cores with f32 accumulation.

Layouts:
  int8: {"q": int8 [in, out], "scale": f32 [out]} — symmetric
        per-output-channel.
  int4: {"q4": int8 [in//2, out] packed BIASED nibbles (stored q+8 in
        [1, 15]; low nibble = row r, high nibble = row in//2 + r), "m8":
        int8 [in//GROUP4, out] per-(k-group, channel) sub-multipliers,
        "scale": f32 [out]} — Q4_K-class grouped quantization:
        w[k, n] ~= nib(k, n) * m8[k // GROUP4, n] * scale[n], nib in
        [-7, 7], m8 in [1, 127]. dequant4_dt rounds the integer product
        nib*m8 once through the model dtype, then the matmul runs.

`linear(x, w)` dispatches on weight type (dense array vs quantized dict) and
is the single matmul entry point used by the decoder stacks.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import jax
import jax.numpy as jnp

Weight = Union[jax.Array, Dict[str, jax.Array]]


GROUP4 = 128      # int4 k-group size (rows sharing one m8 sub-multiplier)


def is_quantized(w: Weight) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def is_quantized4(w: Weight) -> bool:
    return isinstance(w, dict) and "q4" in w and "scale" in w


def quantize(w: jax.Array) -> Dict[str, jax.Array]:
    """Symmetric per-output-channel int8: w [in, out] -> q*scale == ~w."""
    wf = jnp.asarray(w, jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0)                     # [out]
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return {"q": q, "scale": scale.astype(jnp.float32)}


def dequantize(w: Dict[str, jax.Array]) -> jax.Array:
    return w["q"].astype(jnp.float32) * w["scale"]


# ------------------------------------------------------------------- int4
def quantize_int4(w: jax.Array) -> Dict[str, jax.Array]:
    """Grouped symmetric int4: w [K, N] (K % (2*GROUP4) == 0).

    w[k, n] ~= q4(k, n) * m8[k // GROUP4, n] * scale[n] with q4 in [-7, 7].
    """
    wf = jnp.asarray(w, jnp.float32)
    K, N = wf.shape
    assert K % (2 * GROUP4) == 0, (K, N)
    G = K // GROUP4
    amax_gn = jnp.max(jnp.abs(wf.reshape(G, GROUP4, N)), axis=1)     # [G, N]
    amax_n = jnp.max(amax_gn, axis=0)                                # [N]
    scale = jnp.maximum(amax_n, 1e-8) / (7.0 * 127.0)
    m8 = jnp.clip(jnp.round(amax_gn / (7.0 * scale)), 1, 127)
    step = m8 * scale                                                # [G, N]
    q = jnp.clip(jnp.round(wf / jnp.repeat(step, GROUP4, axis=0)), -7, 7)
    q = (q + 8.0).astype(jnp.int32)            # biased storage [1, 15]
    lo = q[: K // 2] & 0xF
    hi = q[K // 2:] & 0xF
    q4 = (lo | (hi << 4)).astype(jnp.uint8).astype(jnp.int8)
    return {"q4": q4, "m8": m8.astype(jnp.int8),
            "scale": scale.astype(jnp.float32)}


def unpack4(q4: jax.Array) -> jax.Array:
    """Packed biased [K//2, N] int8 -> [K, N] int8 nibbles in [-7, 7]."""
    qu = q4.astype(jnp.int32) & 0xFF
    lo = (qu & 0xF) - 8
    hi = ((qu >> 4) & 0xF) - 8
    return jnp.concatenate([lo, hi], axis=0).astype(jnp.int8)


def dequant4_dt(q4: jax.Array, m8: jax.Array, dt) -> jax.Array:
    """Canonical [K, N] dt weight (per-channel scale NOT applied): the
    integer product nib*m8 (<= 889) rounds once through dt."""
    nib = unpack4(q4).astype(jnp.int32)
    m = jnp.repeat(m8.astype(jnp.int32), GROUP4, axis=0)
    return (nib * m).astype(dt)


def dequantize4(w: Dict[str, jax.Array]) -> jax.Array:
    return (dequant4_dt(w["q4"], w["m8"], jnp.float32) * w["scale"])


def qmatmul4(x: jax.Array, w: Dict[str, jax.Array]) -> jax.Array:
    """x [..., in] @ int4-grouped [in, out] -> [..., out] f32.

    Dequant to x.dtype, matmul with f32 accumulation, per-channel scale at
    the end.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wd = dequant4_dt(w["q4"], w["m8"], x2.dtype)
    acc = jax.lax.dot_general(x2, wd, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    out = acc * w["scale"]
    return out.reshape(*lead, w["q4"].shape[1])


def quantize_tree(params: Any, min_size: int = 1 << 16) -> Any:
    """Quantize every 2-D/3-D weight matrix above min_size elements; norms,
    biases and small tensors stay dense. 3-D [L, in, out] tensors quantize
    per layer slice (scale [L, out])."""

    def quantize_leaf(x):
        arr = jnp.asarray(x)
        if arr.ndim == 2 and arr.size >= min_size:
            return quantize(arr)
        if arr.ndim == 3 and arr.size >= min_size:
            wf = arr.astype(jnp.float32)
            amax = jnp.max(jnp.abs(wf), axis=1)             # [L, out]
            scale = jnp.maximum(amax, 1e-8) / 127.0
            q = jnp.clip(jnp.round(wf / scale[:, None, :]), -127, 127)
            return {"q": q.astype(jnp.int8), "scale": scale}
        return x

    return jax.tree_util.tree_map(quantize_leaf, params)


def qmatmul(x: jax.Array, w: Dict[str, jax.Array]) -> jax.Array:
    """x [..., in] @ int8 [in, out] -> [..., out] float32.

    The int8 weight is widened to x.dtype inside the dot's operand, so a
    bf16 model runs a bf16 GEMM with f32 accumulation and the per-channel
    scale is applied to the f32 result."""
    q, scale = w["q"], w["scale"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    acc = jax.lax.dot_general(x2, q.astype(x2.dtype), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return (acc * scale).reshape(*lead, q.shape[1])


def linear(x: jax.Array, w: Weight) -> jax.Array:
    """Single matmul entry point: dense array, int8 or int4 dict."""
    if is_quantized(w):
        return qmatmul(x, w).astype(x.dtype)
    if is_quantized4(w):
        return qmatmul4(x, w).astype(x.dtype)
    return x @ w


_DECODER_MATMULS = ("wqkv", "wo", "w_gu", "w_down")


def quantize_decoder_params(params: Dict[str, Any],
                            kind: str = "int8") -> Dict[str, Any]:
    """Quantize a models/decoder pytree: the four stacked layer matmuls
    (per layer slice) and the output head; norms stay dense.
    kind: "int8" (per-channel) or "int4" (grouped, Q4_K-class)."""

    def q3(w):  # [L, in, out] -> per-(layer, out-channel) scales
        wf = jnp.asarray(w, jnp.float32)
        amax = jnp.max(jnp.abs(wf), axis=1)
        scale = jnp.maximum(amax, 1e-8) / 127.0
        q = jnp.clip(jnp.round(wf / scale[:, None, :]), -127, 127)
        return {"q": q.astype(jnp.int8), "scale": scale}

    def q3_int4(w):  # [L, in, out] -> stacked int4 dicts
        # sequential over layers (lax.map, not vmap): quantization builds
        # f32 temporaries of the full matrix, and a vmapped stack of them
        # OOMs HBM on real-size models (28 x [2048, 12288] f32 transients)
        return jax.lax.map(quantize_int4, jnp.asarray(w))

    qfn3 = q3 if kind == "int8" else q3_int4
    qfn2 = quantize if kind == "int8" else quantize_int4
    layers = dict(params["layers"])
    for name in _DECODER_MATMULS:
        layers[name] = qfn3(layers[name])
    return {
        "layers": layers,
        "final_norm": params["final_norm"],
        "head": qfn2(params["head"]),
    }
