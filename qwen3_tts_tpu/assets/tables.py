"""Embedding tables + projection ("assets") as device arrays.

Counterpart of the reference `Assets`
(`src/assets_manager.rs:5-461`): the text table [151936, 2048], the 16 codec
codebook tables (stacked [16, rows, 2048]), and the 2048->1024 projection.
Lookups are `jnp.take`; the projection is a single matmul; everything is
vectorised so prompt assembly and the decode loop never leave the device.

Semantics preserved from the reference:
  * codec lookup clamps negative codes to 0 and returns zeros for
    out-of-range rows (`src/assets_manager.rs:419-437`) — we zero-pad all
    tables to a common row count so OOB rows read back zeros;
  * `tts_pad` is text-table row 151671 (`src/assets_manager.rs:244-250`);
  * text-table OOB falls back to the deterministic pseudo-random pattern
    `((id*17 + i) % 2) - 1` (`src/assets_manager.rs:454-460`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import protocol
from . import gguf


@jax.tree_util.register_pytree_node_class
@dataclass
class Assets:
    text_table: jax.Array        # [text_vocab, 2048]
    codec_tables: jax.Array      # [16, rows, 2048] zero-padded to common rows
    proj_weight: jax.Array       # [1024, 2048]  (PyTorch Linear layout)
    proj_bias: jax.Array         # [1024]

    def tree_flatten(self):
        return (
            (self.text_table, self.codec_tables, self.proj_weight, self.proj_bias),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # --- derived ---
    @property
    def tts_pad(self) -> jax.Array:
        """Text-table row 151671, added to every talker feedback embedding."""
        return self.text_table[protocol.TEXT_AUDIO_MARKER]

    @property
    def codec_rows(self) -> int:
        return self.codec_tables.shape[1]

    # --- ops (all jit-safe) ---
    def project(self, hidden: jax.Array) -> jax.Array:
        """Dense 2048 -> 1024 (`src/assets_manager.rs:383-399`)."""
        return hidden @ self.proj_weight.T + self.proj_bias

    def codec_embedding(self, q, code) -> jax.Array:
        """codec_tables[q][code] with clamp-to-0 / OOB-zeros semantics.

        `q` and `code` may be scalars or arrays (broadcast together);
        returns [..., 2048].
        """
        q = jnp.asarray(q, jnp.int32)
        code = jnp.asarray(code, jnp.int32)
        clamped = jnp.maximum(code, 0)
        valid = clamped < self.codec_rows
        safe = jnp.minimum(clamped, self.codec_rows - 1)
        emb = self.codec_tables[q, safe]
        return jnp.where(valid[..., None], emb, 0.0)

    def codec_embedding_1024(self, q, code) -> jax.Array:
        """Table row then projection (`src/assets_manager.rs:439-442`)."""
        return self.project(self.codec_embedding(q, code))

    def text_embedding(self, token_id) -> jax.Array:
        """text_table[token_id] with the deterministic OOB fallback pattern."""
        token_id = jnp.asarray(token_id, jnp.int32)
        valid = (token_id >= 0) & (token_id < self.text_table.shape[0])
        safe = jnp.clip(token_id, 0, self.text_table.shape[0] - 1)
        emb = self.text_table[safe]
        dim = self.text_table.shape[1]
        i = jnp.arange(dim, dtype=jnp.int32)
        fallback = (
            ((token_id[..., None] * 17 + i) % 2).astype(self.text_table.dtype) - 1.0
        )
        return jnp.where(valid[..., None], emb, fallback)

    def frame_embedding_sum(self, frame_codes: jax.Array) -> jax.Array:
        """Sum_q codec_tables[q][code_q] for one or more 16-code frames.

        frame_codes: [..., 16] int32 -> [..., 2048]. Used for both the
        clone-prompt audio block (`src/tts/prompt.rs:79-96`) and the talker
        feedback embedding (`src/tts/engine.rs:623-631`).
        """
        q = jnp.arange(self.codec_tables.shape[0], dtype=jnp.int32)
        embs = self.codec_embedding(q, frame_codes)     # [..., 16, 2048]
        return jnp.sum(embs, axis=-2)


def load_assets(model_dir: str, dtype=jnp.float32) -> Assets:
    """Load from `<dir>/qwen3_assets.gguf`, falling back to NPY files, the
    same resolution order as the reference (`src/assets_manager.rs:14-26`)."""
    gguf_path = os.path.join(model_dir, "qwen3_assets.gguf")
    if os.path.exists(gguf_path):
        f = gguf.GGUFFile(gguf_path)
        proj_w = f.read_tensor("proj.weight")
        proj_b = f.read_tensor("proj.bias")
        text = (
            f.read_tensor("text_embd")
            if "text_embd" in f.tensors
            else np.zeros((0, protocol.EMBED_DIM), np.float32)
        )
        codecs = [
            f.read_tensor(f"codec_embd.{i}")
            for i in range(protocol.NUM_CODEBOOKS)
            if f"codec_embd.{i}" in f.tensors
        ]
    elif not os.path.exists(os.path.join(model_dir, "proj_weight.npy")):
        raise FileNotFoundError(
            f"no embedding tables in {model_dir!r}: expected "
            "qwen3_assets.gguf or proj_weight.npy (run "
            "TtsEngine.download_models or tools/convert_weights.py)")
    else:
        proj_w = np.load(os.path.join(model_dir, "proj_weight.npy"))
        proj_b = np.load(os.path.join(model_dir, "proj_bias.npy"))
        text_path = os.path.join(model_dir, "text_embedding_projected.npy")
        text = (
            np.load(text_path)
            if os.path.exists(text_path)
            else np.zeros((0, protocol.EMBED_DIM), np.float32)
        )
        codecs = []
        for i in range(protocol.NUM_CODEBOOKS):
            p = os.path.join(model_dir, f"codec_embedding_{i}.npy")
            if os.path.exists(p):
                codecs.append(np.load(p))
    return build_assets(text, codecs, proj_w, proj_b, dtype=dtype)


def build_assets(text, codecs, proj_w, proj_b, dtype=jnp.float32) -> Assets:
    proj_w = np.asarray(proj_w, np.float32)
    if proj_w.ndim == 1:
        proj_w = proj_w.reshape(protocol.PROJ_DIM, -1)
    dim = proj_w.shape[-1]   # 2048 in production; configurable for tests
    text = np.asarray(text, np.float32).reshape(-1, dim)
    proj_b = np.asarray(proj_b, np.float32).reshape(-1)
    codecs = [np.asarray(c, np.float32).reshape(-1, dim) for c in codecs]
    if not codecs:
        raise ValueError("no codec embedding tables found")
    rows = max(c.shape[0] for c in codecs)
    stacked = np.zeros((protocol.NUM_CODEBOOKS, rows, dim), np.float32)
    for i, c in enumerate(codecs):
        stacked[i, : c.shape[0]] = c   # zero padding == OOB-zeros semantics
    return Assets(
        text_table=jnp.asarray(text, dtype),
        codec_tables=jnp.asarray(stacked, dtype),
        proj_weight=jnp.asarray(proj_w, dtype),
        proj_bias=jnp.asarray(proj_b, dtype),
    )


def random_assets(
    key: jax.Array,
    text_vocab: int = 4096,
    codec_rows: int = 3072,
    dim: int = protocol.EMBED_DIM,
    proj_dim: int = protocol.PROJ_DIM,
    dtype=jnp.float32,
    scale: float = 0.02,
) -> Assets:
    """Seeded random tables for tests/benchmarks (no public weights in CI)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return Assets(
        text_table=(scale * jax.random.normal(k1, (text_vocab, dim))).astype(dtype),
        codec_tables=(
            scale * jax.random.normal(k2, (protocol.NUM_CODEBOOKS, codec_rows, dim))
        ).astype(dtype),
        proj_weight=(scale * jax.random.normal(k3, (proj_dim, dim))).astype(dtype),
        proj_bias=(scale * jax.random.normal(k4, (proj_dim,))).astype(dtype),
    )
