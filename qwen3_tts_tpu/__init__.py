"""qwen3_tts_tpu — Qwen3-TTS framework in JAX / XLA.

Public facade mirroring the reference library surface (`src/lib.rs:10-20`):
TtsEngine, SamplerConfig, PromptBuilder, AudioSample, Tokenizer, VoiceFile,
cleanup().
"""

from .core.config import (  # noqa: F401
    EngineConfig,
    SamplerConfig,
    TalkerConfig,
    PredictorConfig,
    VocoderConfig,
    tiny_engine_config,
)
from .tts import prompt as _prompt
from .tts.engine import TtsEngine, cleanup  # noqa: F401
from .utils.audio import AudioSample  # noqa: F401
from .utils.tokenizer import ByteTokenizer, Tokenizer  # noqa: F401
from .utils.voice_file import VoiceFile  # noqa: F401

__version__ = "0.1.0"


class PromptBuilder:
    """Static facade over tts.prompt (reference PromptBuilder,
    src/tts/prompt.rs:24-278)."""

    build_core = staticmethod(_prompt.build_core)
    build_clone_prompt = staticmethod(_prompt.build_clone_prompt)
    build_custom_prompt = staticmethod(_prompt.build_custom_prompt)


__all__ = [
    "TtsEngine",
    "SamplerConfig",
    "PromptBuilder",
    "AudioSample",
    "Tokenizer",
    "ByteTokenizer",
    "VoiceFile",
    "EngineConfig",
    "TalkerConfig",
    "PredictorConfig",
    "VocoderConfig",
    "tiny_engine_config",
    "cleanup",
]
