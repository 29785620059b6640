"""Multi-host smoke as a (skippable) pytest: 2 Gloo CPU processes, one
global mesh, one sharded generation step (VERDICT r1 #10 — promoted from
tools/multihost_smoke.py so CI exercises the jax.distributed path).

Runs in subprocesses (jax.distributed cannot re-init inside the test
process); skipped when the environment cannot bind localhost sockets or
under QWEN3_TTS_SKIP_MULTIHOST=1.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # multi-process Gloo subprocess harnesses (docs/TESTING.md)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _can_bind() -> bool:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        s.close()
        return True
    except OSError:
        return False


@pytest.mark.skipif(
    os.environ.get("QWEN3_TTS_SKIP_MULTIHOST") == "1" or not _can_bind(),
    reason="multihost smoke disabled or no localhost sockets",
)
def test_two_process_gloo_smoke():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)           # worker sets its own device count
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "global devices: 8" in out, out[-3000:]


@pytest.mark.skipif(
    os.environ.get("QWEN3_TTS_SKIP_MULTIHOST") == "1" or not _can_bind(),
    reason="multihost smoke disabled or no localhost sockets",
)
def test_scaling_harness(tmp_path):
    """The 1-vs-2-process weak-scaling harness (BASELINE >=90% target).

    Host-local DP: each process runs its own fused generation program on
    its own pinned cores — no cross-process collective in the decode loop —
    so the 2-process aggregate throughput must track 2x the 1-process one.
    The harness's own target at steps=16 reps=5 is >=0.90; this CI run
    uses shorter programs where scheduler noise on a
    2-core box is proportionally larger, so it gates at 0.6 — still far
    above the 0.078 the pre-host-local design measured."""
    import json

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_scaling.py"),
         "--steps", "8", "--reps", "3", "--port", "29461"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["mode"] == "local"
    assert report["throughput_1p_audio_s_per_s"] > 0
    assert report["throughput_2p_audio_s_per_s"] > 0
    assert report["scaling_efficiency"] > 0.6, report
