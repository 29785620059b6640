"""Continuous-batching multi-stream serving engine.

New first-class surface (the reference is strictly single-stream, one CLI
invocation per utterance): a fixed device batch of `max_streams` slots runs
ONE fused 4-frame step program per tick; streams are admitted into free slots
mid-flight by scattering their prefilled KV rows into the batch cache, and
released on EOS. Fixed shapes keep XLA from recompiling (SURVEY.md §7
"continuous batching of ragged utterances": masking + slot reuse).

Correctness invariant (tested): a stream's greedy output is bit-identical to
running it alone — per-row attention masks and per-slot vocoder state make
co-batched streams non-interacting.

Host-side bookkeeping (slot lifecycle, chunk batching) rides the native
ttsrt runtime when built.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import runtime
from .core import protocol as P
from .core.config import EngineConfig
from .models import decoder, talker, vocoder
from .tts import generate, prompt
from .tts.engine import TtsEngine
from .utils.audio import AudioSample
from .utils.voice_file import VoiceFile


@dataclasses.dataclass
class _Stream:
    stream_id: int
    slot: int
    on_chunk: Optional[Callable[[np.ndarray], None]]
    pieces: List[np.ndarray] = dataclasses.field(default_factory=list)
    frames: int = 0              # generated frames kept (cap-clamped)
    emitted: int = 0             # waveform samples emitted so far
    done: bool = False
    result: Optional[AudioSample] = None
    error: Optional[str] = None


class ServingEngine:
    """Multi-stream streaming TTS over one device batch."""

    def __init__(self, engine: TtsEngine, max_streams: int = 4,
                 chunk_frames: int = P.STREAM_CHUNK_FRAMES,
                 kv_window: Optional[int] = None):
        """`kv_window` bounds every slot's talker KV extent (256-aligned
        recommended): serving rarely needs max_seq=4096 live slots per
        stream, and the default cache is 469 MB/row on the flagship talker
        — a 1024-slot window fits 4x the streams in the same HBM. Streams
        whose prompt+frames would exceed the window stop cleanly at it
        (the same context-cap semantics as max_seq)."""
        self.engine = engine
        self.cfg: EngineConfig = engine.config
        self.B = max_streams
        self.chunk_frames = chunk_frames
        self.kv_window = kv_window
        self.slots = runtime.SlotManager(max_streams)
        self.streams: Dict[int, _Stream] = {}
        self._slot_stream: Dict[int, int] = {}

        cfg = self.cfg
        tcfg = cfg.talker
        # batch-wide generation state (all slots, fixed shapes)
        self._state = None      # lazily built on first submit
        self._vstate = vocoder.init_state(cfg.vocoder, max_streams)

        sc = engine.sampler_config
        if (chunk_frames == P.STREAM_CHUNK_FRAMES and kv_window is None
                and hasattr(engine, "_get_stream_fns")):
            # share the engine's memoised pair so warmup_streaming() compiles
            # carry over to serving
            self._prefill_fn, self._step_fn = engine._get_stream_fns()
        else:
            self._prefill_fn, self._step_fn = generate.make_stream_fns(
                tcfg, cfg.predictor, top_k=sc.top_k,
                frames_per_call=chunk_frames, cache_len=kv_window)

    def warmup(self) -> None:
        """Precompile the serving-batch step (per-row slot vector state — a
        different program than single-stream) + the chunk vocoder + the
        single-row prefill used at admission."""
        st = self._blank_state()
        st, codes, active = self._step_fn(self.engine.models, st)
        jax.block_until_ready((codes, active))
        wav, _, _ = vocoder.decode(
            self.engine.vocoder_params, self.cfg.vocoder,
            jnp.zeros((self.B, self.chunk_frames, P.NUM_CODEBOOKS),
                      jnp.int32),
            vocoder.init_state(self.cfg.vocoder, self.B), False)
        jax.block_until_ready(wav)
        # admission-time prefill compiles per prompt bucket
        self.engine.warmup_streaming(batch=1)

    # ------------------------------------------------------------------ admit
    def _blank_state(self):
        cfg = self.cfg.talker
        B = self.B
        return dict(
            key=jax.random.key(0),
            hidden=jnp.zeros((B, cfg.hidden), jnp.dtype(cfg.dtype)),
            logits=jnp.full((B, cfg.vocab), -1e9, jnp.float32),
            cache=decoder.init_kv_cache(cfg, B, length=self.kv_window),
            slot=jnp.zeros((B,), jnp.int32),   # per-row cache positions
            step=jnp.int32(0),
            pad_offset=jnp.zeros((B,), jnp.int32),
            done=jnp.ones((B,), bool),          # empty slots are "done"
            n_frames=jnp.zeros((B,), jnp.int32),
            temperature=jnp.float32(self.engine.sampler_config.temperature),
            top_p=jnp.float32(self.engine.sampler_config.top_p),
            prev_codes=jnp.zeros((B, P.NUM_CODEBOOKS - 1), jnp.int32),
        )

    def submit(self, text: str, voice: VoiceFile,
               instruct: Optional[str] = None,
               on_chunk: Optional[Callable[[np.ndarray], None]] = None,
               ) -> Optional[int]:
        """Admit a stream. Returns stream_id, or None when the batch is full."""
        slot, sid = self.slots.acquire()
        if slot is None:
            return None
        if self._state is None:
            self._state = self._blank_state()

        try:
            data = self.engine._prompt_for_voice(text, voice, instruct)
            # rejects admissions whose prompt alone fills the talker context
            # (n_ctx=4096, src/tts/engine.rs:133) or the serving KV window:
            # no room for even 1 frame
            batch1, offs1 = self.engine._pad_prompts([data.embeds])
            if self.kv_window is not None \
                    and batch1.shape[1] >= self.kv_window:
                raise ValueError(
                    f"prompt ({batch1.shape[1]} slots) fills the serving "
                    f"KV window ({self.kv_window})")
        except Exception as e:   # bad voice/text must not poison the batch
            self.slots.release(slot)
            s = _Stream(stream_id=sid, slot=-1, on_chunk=on_chunk,
                        done=True, error=f"prompt build failed: {e}")
            s.result = AudioSample(samples=np.zeros(0, np.float32),
                                   sample_rate=P.SAMPLE_RATE, channels=1)
            self.streams[sid] = s
            return sid
        key = self.engine._seed_key()
        sc = self.engine.sampler_config
        st1 = self._prefill_fn(
            self.engine.models, batch1, offs1, key, sc.temperature, sc.top_p)
        self._state = _scatter_row(self._state, st1, slot)
        self._vstate = _reset_vocoder_row(self._vstate, self.cfg.vocoder, slot)
        s = _Stream(stream_id=sid, slot=slot, on_chunk=on_chunk)
        self.streams[sid] = s
        self._slot_stream[slot] = sid
        return sid

    # ------------------------------------------------------------------- step
    def step(self) -> int:
        """Advance every active stream by one chunk (one device dispatch).
        Returns the number of active streams after the tick."""
        if self._state is None or self.slots.active() == 0:
            return 0
        self._state, codes, active = self._step_fn(
            self.engine.models, self._state)
        codes = np.asarray(codes)           # [B, chunk, 16]
        active = np.asarray(active)         # [B, chunk]
        done = np.asarray(self._state["done"])

        # vocode all slots in one batched call, then trim per stream by the
        # per-row valid_samples (the vocoder withholds its lookahead window:
        # emission lags generation by `lookahead` frames until the flush)
        fs = self.cfg.vocoder.frame_samples
        n_new = active.sum(axis=1)          # frames per slot this tick
        if n_new.max(initial=0) > 0:
            chunk = jnp.asarray(codes[:, : self.chunk_frames], jnp.int32)
            wav, valid, self._vstate = vocoder.decode(
                self.engine.vocoder_params, self.cfg.vocoder, chunk,
                self._vstate, False)
            wav = np.asarray(wav)
            valid = np.asarray(valid)
        else:
            wav = np.zeros(
                (self.B,
                 (self.chunk_frames + self.cfg.vocoder.lookahead) * fs),
                np.float32)
            valid = np.zeros((self.B,), np.int64)

        # per-stream frame cap: --max-steps AND the vocoder's streaming KV
        # capacity. A live row's vocoder state advances chunk_frames per tick
        # whether or not the generator emitted a full chunk, so a stream must
        # end while ceil(frames/chunk)*chunk still fits max_frames — hence
        # the `- chunk_frames` headroom (VERDICT r1 #5).
        frame_cap = min(self.engine.max_steps,
                        self.cfg.vocoder.max_frames - self.chunk_frames)
        for slot, sid in list(self._slot_stream.items()):
            s = self.streams[sid]
            k = min(int(n_new[slot]), max(frame_cap - s.frames, 0))
            if k > 0:
                s.frames += k
                self.slots.mark_frames(slot, k)
            self._emit(s, slot, wav[slot], int(valid[slot]))
            max_hit = s.frames >= frame_cap
            if bool(done[slot]) or max_hit:
                # drain the row's withheld lookahead frames (the per-stream
                # analog of the reference's is_last call)
                fwav, fvalid, _ = vocoder.flush(
                    self.engine.vocoder_params, self.cfg.vocoder,
                    vocoder.gather_row(self._vstate, slot))
                self._emit(s, slot, np.asarray(fwav)[0],
                           int(np.asarray(fvalid)[0]))
                s.done = True
                s.result = AudioSample(
                    samples=(np.concatenate(s.pieces) if s.pieces
                             else np.zeros(0, np.float32)),
                    sample_rate=P.SAMPLE_RATE, channels=1)
                self.slots.mark_eos(slot)
                self.slots.release(slot)
                del self._slot_stream[slot]
                # mark the row done so the device loop stops emitting for it
                self._state["done"] = jnp.asarray(
                    np.asarray(self._state["done"]) | _onehot(slot, self.B))
        return self.slots.active()

    def _emit(self, s: _Stream, slot: int, row_wav: np.ndarray,
              valid: int) -> None:
        """Append finalized samples, clamped so a stream never emits past its
        kept-frame budget (frames beyond EOS / the cap were still fed to the
        batched vocoder, but their samples sit past the budget and are
        dropped here)."""
        fs = self.cfg.vocoder.frame_samples
        e = min(valid, s.frames * fs - s.emitted)
        if e > 0:
            piece = row_wav[:e]
            s.pieces.append(piece)
            s.emitted += e
            if s.on_chunk is not None:
                s.on_chunk(piece)

    def run_until_drained(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if self.step() == 0 and self.slots.active() == 0:
                break

    def result(self, stream_id: int) -> Optional[AudioSample]:
        s = self.streams.get(stream_id)
        return s.result if s and s.done else None


def _onehot(i: int, n: int) -> np.ndarray:
    v = np.zeros(n, bool)
    v[i] = True
    return v


@functools.partial(jax.jit, static_argnames=("row",))
def _scatter_state(big, small, row: int):
    def scatter(b, s):
        return jax.lax.dynamic_update_slice(
            b, s.astype(b.dtype), (row,) + (0,) * (b.ndim - 1))

    out = dict(big)
    out["hidden"] = scatter(big["hidden"], small["hidden"])
    out["logits"] = scatter(big["logits"], small["logits"])
    out["pad_offset"] = scatter(big["pad_offset"], small["pad_offset"])
    out["done"] = scatter(big["done"], jnp.zeros((1,), bool))
    out["n_frames"] = scatter(big["n_frames"], jnp.zeros((1,), jnp.int32))
    # cache rows: [L, B, T, nk, hd] <- [L, 1, T', nk, hd] (T' <= T, rest zero)
    cache = {}
    for kname in ("k", "v"):
        b = big["cache"][kname]
        s = small["cache"][kname]
        s_pad = jnp.zeros((b.shape[0], 1) + b.shape[2:], b.dtype)
        s_pad = jax.lax.dynamic_update_slice(
            s_pad, s.astype(b.dtype), (0,) * s.ndim)
        cache[kname] = jax.lax.dynamic_update_slice(
            b, s_pad, (0, row) + (0,) * (b.ndim - 2))
    out["cache"] = cache
    return out


def _scatter_row(big, small, row: int):
    """Insert a freshly prefilled single-row state into batch row `row`.

    Cache positions are PER ROW (`slot` is [B]): the admitted row starts at
    its own prompt length while running rows keep their extents — this is
    what makes staggered admission non-interacting (zero cache slots beyond a
    row's own extent are masked by its per-row kv_len).

    RNG: the batch shares one key stream; admission folds in the new
    stream's entropy. Greedy decoding is unaffected; sampled co-batched
    streams draw from the same distributions as solo runs but not the same
    sequence (documented RNG policy).
    """
    new = _scatter_state(big, small, row)
    slot_b = jnp.broadcast_to(jnp.asarray(big["slot"], jnp.int32),
                              new["done"].shape)
    new["slot"] = slot_b.at[row].set(
        jnp.asarray(small["slot"], jnp.int32).reshape(()))
    new["key"] = jax.random.fold_in(small["key"], row)
    new["step"] = big["step"]
    new["temperature"] = small["temperature"]
    new["top_p"] = small["top_p"]
    return new


def _reset_vocoder_row(vstate, vcfg, row: int):
    return vocoder.reset_row(vstate, row)
