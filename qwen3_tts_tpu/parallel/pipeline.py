"""Talker -> vocoder pipelining: host-side async stage decoupling.

Analog of the reference's dedicated decoder thread + mpsc channel
(`src/tts/engine.rs:487-543`): generation keeps dispatching talker/predictor
steps while a worker thread owns the vocoder dispatches and the host-side
PCM conversion, so neither stage stalls the other. JAX dispatch is already
asynchronous on-device; what the thread buys is overlapping the *host* work
(numpy conversion, chunk callbacks, WAV writes) with device compute, and a
bounded queue for backpressure.

Ordering and state-threading are preserved: chunks are vocoded strictly in
submission order against the carried VocoderState (chunked == one-shot
exactness is a vocoder property, tested in test_vocoder).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np

from ..core.config import VocoderConfig
from ..models import vocoder


class VocoderPipeline:
    """Worker thread that owns vocoder dispatches for one stream batch."""

    def __init__(self, params, cfg: VocoderConfig, batch: int = 1,
                 on_chunk: Optional[Callable[[np.ndarray], None]] = None,
                 max_queue: int = 8):
        self.params = params
        self.cfg = cfg
        self.on_chunk = on_chunk
        self.state = vocoder.init_state(cfg, batch)
        self.pieces: List[np.ndarray] = []
        self.error: Optional[BaseException] = None
        self._flushed = False
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, codes: np.ndarray, is_final: bool = False) -> None:
        """codes [B, n_frames, 16]; blocks when the queue is full
        (backpressure, like the reference's bounded channel semantics)."""
        self._q.put((np.asarray(codes, np.int32), bool(is_final)))

    def _run(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                codes, is_final = item
                if codes.shape[1] > 0:
                    wav, valid, self.state = vocoder.decode(
                        self.params, self.cfg, jnp.asarray(codes),
                        self.state, is_final)
                    self._flushed = is_final
                elif is_final:
                    # stream ended between chunks: drain the lookahead
                    # window (the reference's N=0 is_last call)
                    wav, valid, self.state = vocoder.flush(
                        self.params, self.cfg, self.state)
                    self._flushed = True
                else:
                    continue
                piece = np.asarray(wav)[0, : int(valid[0])]
                if piece.size:
                    self.pieces.append(piece)
                    if self.on_chunk is not None:
                        self.on_chunk(piece)
                if is_final:
                    return
        except BaseException as e:   # surfaced to the caller at close()
            self.error = e

    def close(self) -> np.ndarray:
        """Flush, join, and return the concatenated waveform."""
        if not self._flushed:
            # emit any withheld lookahead frames before shutting down
            self._q.put((np.zeros((self.state.frames_done.shape[0], 0, 16),
                                  np.int32), True))
        self._q.put(None)
        self._thread.join()
        if self.error is not None:
            raise RuntimeError(f"vocoder pipeline failed: {self.error!r}")
        return (np.concatenate(self.pieces) if self.pieces
                else np.zeros(0, np.float32))
