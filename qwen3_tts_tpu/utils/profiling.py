"""Observability: per-stage timers, RTF metrics, jax.profiler integration.

The reference has none of this — its only instrumentation is `println!`
wall-clock lines (`src/bin/qwen3_tts.rs:146-155`) and a `\\r` step counter
(`src/tts/engine.rs:546`); it even disables llama.cpp's perf counters
(SURVEY.md §5). This module provides what a production serving stack needs:
structured stage timings (prefill / frame / vocode chunk), derived RTF and
first-chunk latency, and one-call access to XLA profiler traces.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

from ..core import protocol as P


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class GenerationMetrics:
    """Collects stage timings across one or more generations."""

    stages: Dict[str, StageStats] = field(default_factory=dict)
    frames: int = 0
    audio_samples: int = 0
    first_chunk_s: Optional[float] = None
    _start: Optional[float] = None

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, StageStats()).add(
                time.perf_counter() - t0)

    def begin(self) -> None:
        self._start = time.perf_counter()

    def chunk_emitted(self, n_samples: int) -> None:
        if self.first_chunk_s is None and self._start is not None:
            self.first_chunk_s = time.perf_counter() - self._start
        self.audio_samples += n_samples

    @property
    def audio_seconds(self) -> float:
        return self.audio_samples / P.SAMPLE_RATE

    @property
    def wall_seconds(self) -> float:
        return sum(s.total_s for s in self.stages.values())

    @property
    def rtf(self) -> float:
        a = self.audio_seconds
        return self.wall_seconds / a if a > 0 else float("inf")

    def report(self) -> Dict:
        return {
            "rtf": round(self.rtf, 4),
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "first_chunk_ms": (
                round(1000 * self.first_chunk_s, 1)
                if self.first_chunk_s is not None else None),
            "stages": {
                k: {"count": s.count, "mean_ms": round(1000 * s.mean_s, 2),
                    "total_s": round(s.total_s, 3)}
                for k, s in self.stages.items()
            },
        }

    def log(self, sink=None) -> None:
        line = json.dumps({"event": "generation_metrics", **self.report()})
        (sink or print)(line)


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace scope; no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def card_info() -> str:
    """The card's name and power limit as nvidia-smi prints them, read by a
    child process that stays off JAX. Raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_record() -> Dict:
    """The device as JAX reports it: platform, device_kind and count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
