"""Partition specs: how every weight / activation maps onto the mesh.

Megatron-style tensor parallelism for the decoder stacks: QKV and MLP
up-projections are column-sharded over `model` (head dimension splits),
output / down projections row-sharded, so each layer needs exactly one
psum (XLA inserts it from these annotations). KV caches shard over the
kv-head axis; utterance batches over `data`. Embedding tables and the small
projection are replicated — they are lookup-bound, not FLOP-bound.

Scaling-book recipe: pick the mesh, annotate shardings, let XLA place the
collectives on the device links, profile, iterate.
"""

from __future__ import annotations

from typing import Any, Dict

from jax.sharding import PartitionSpec as P

from ..assets.tables import Assets
from .mesh import DATA_AXIS, MODEL_AXIS


def interleave_perm(nq: int, nk: int, hd: int, m: int):
    """Column permutation taking the flat fused-qkv layout [q | k | v] to
    `m` device blocks [q_d | k_d | v_d] (d = 0..m-1), where block d holds
    the original contiguous head ranges d*nq/m.. and d*nk/m.. — so GSPMD's
    contiguous column shards of the permuted matrix align exactly with the
    per-device q/k/v split (no resharding after the qkv matmul), while the
    recomposed global head order is unchanged (decoder.forward ni-split).
    """
    import numpy as np

    assert nq % m == 0 and nk % m == 0, (nq, nk, m)
    nqm, nkm = nq // m, nk // m
    q_off, k_off, v_off = 0, nq * hd, (nq + nk) * hd
    perm = []
    for d in range(m):
        perm.append(np.arange(q_off + d * nqm * hd,
                              q_off + (d + 1) * nqm * hd))
        perm.append(np.arange(k_off + d * nkm * hd,
                              k_off + (d + 1) * nkm * hd))
        perm.append(np.arange(v_off + d * nkm * hd,
                              v_off + (d + 1) * nkm * hd))
    return np.concatenate(perm)


def interleave_wqkv(wqkv, cfg, m: int):
    """Apply interleave_perm to a stacked dense wqkv [L, H, (nq+2nk)*hd]."""
    assert not isinstance(wqkv, dict), \
        "TP interleave applies to dense weights (quantize after)"
    perm = interleave_perm(cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim, m)
    return wqkv[..., perm]


def decoder_param_specs() -> Dict[str, Any]:
    """Specs matching models.decoder init_decoder's pytree layout
    ([L, ...] stacked layers)."""
    return {
        "layers": {
            "ln1": P(),
            "wqkv": P(None, None, MODEL_AXIS),   # column: heads split
            "q_norm": P(),
            "k_norm": P(),
            "wo": P(None, MODEL_AXIS, None),     # row: psum after
            "ln2": P(),
            "w_gu": P(None, None, MODEL_AXIS),
            "w_down": P(None, MODEL_AXIS, None),
        },
        "final_norm": P(),
        "head": P(None, MODEL_AXIS),             # vocab-sharded logits
    }


def assets_specs() -> Assets:
    # same pytree node type as the real Assets so tree_map structures match
    return Assets(
        text_table=P(),
        codec_tables=P(),
        proj_weight=P(),
        proj_bias=P(),
    )


def models_specs() -> Dict[str, Any]:
    """Specs for the engine's `models` dict (talker/predictor/assets)."""
    return {
        "talker": decoder_param_specs(),
        "predictor": decoder_param_specs(),
        "assets": assets_specs(),
    }


def kv_cache_specs() -> Dict[str, Any]:
    # [L, B, n_kv_heads, T, head_dim] (head-major layout)
    spec = P(None, DATA_AXIS, MODEL_AXIS, None, None)
    return {"k": spec, "v": spec}


def batch_spec() -> P:
    """Utterance-batch activations: [B, S, H]."""
    return P(DATA_AXIS)


def vocoder_param_specs() -> Dict[str, Any]:
    conv = {"w": P(), "b": P()}
    return {
        "embed": P(),
        "pre_conv": conv,
        "transformer": decoder_param_specs(),
        "post_a": conv,
        "post_b": conv,
        # transposed-conv matmul stages: shard the wide output columns
        "up": [{"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)}
               for _ in range(5)],
    }
