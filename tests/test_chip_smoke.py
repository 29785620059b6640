"""chip_smoke.py's phases at tiny widths on the CPU, its refusal of any
device but a GPU (and bench.py's), and the same phases at the flagship
widths on the card (`gpu` marker)."""

import dataclasses

import pytest

import bench
import chip_smoke
from qwen3_tts_tpu.core.config import EngineConfig, TalkerConfig, \
    tiny_engine_config

TINY = tiny_engine_config(max_steps=8)
# talker widths that int4's 256-row packing accepts (tiny's 64 does not)
QUANT_CFG = dataclasses.replace(TINY, talker=TalkerConfig(
    hidden=256, n_layers=1, n_q_heads=2, n_kv_heads=1, head_dim=64,
    ffn_dim=512, mrope_sections=(16, 8, 8, 0)))

PHASES = {
    "talker": (chip_smoke.check_talker, TINY, 3),
    "predictor": (chip_smoke.check_predictor, TINY, 2),
    "quant": (chip_smoke.check_quant, QUANT_CFG, 6),
    "vocoder": (chip_smoke.check_vocoder, TINY, 1),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_check_phase_passes_tiny(phase):
    fn, cfg, n = PHASES[phase]
    checks = fn(cfg)
    assert len(checks) == n
    assert all(c.ok for c in checks), [c.line() for c in checks]


@pytest.mark.parametrize("value,tol,negative,ok", [
    (1e-3, 1e-2, False, True),
    (1e-1, 1e-2, False, False),
    (1e-3, 1e-4, True, True),
    (1e-5, 1e-4, True, False),
    (float("nan"), 1e-2, False, False),
])
def test_check_verdict(value, tol, negative, ok):
    c = chip_smoke.Check("c", value, tol, "r", "p", negative=negative)
    assert c.ok is ok
    assert c.line().endswith("PASS" if ok else "FAIL")


def test_main_path_tiny():
    info = chip_smoke.run_main_path(TINY, max_steps=8, max_streams=2,
                                    timeout=300)
    assert info["offline_frames"] > 0 and info["stream_frames"] > 0
    assert info["stream_chunks"] >= 2
    assert len(info["http_frames"]) == 3 and min(info["http_frames"]) > 0


@pytest.mark.parametrize("entry", [chip_smoke.main, bench.main])
def test_refuses_cpu(entry, capsys):
    assert entry() != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out and out.strip() == ""


@pytest.mark.gpu
def test_flagship_checks_on_card(gpu):
    checks = chip_smoke.run_checks(EngineConfig())
    assert all(c.ok for c in checks), [c.line() for c in checks]


@pytest.mark.gpu
def test_flagship_main_path_on_card(gpu):
    info = chip_smoke.run_main_path(EngineConfig())
    assert info["offline_frames"] > 0 and info["stream_chunks"] >= 2
