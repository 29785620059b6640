#!/usr/bin/env python
"""Multi-host smoke: 2 processes x 4 virtual CPU devices, one global mesh.

Validates the `jax.distributed` init path and cross-process sharded
generation (DP over hosts, TP within a host) without a cluster — the CPU
analog of a multi-host serving config.

Run:  python tools/multihost_smoke.py            # spawns both workers
      python tools/multihost_smoke.py --rank N   # worker entry
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 29401


def worker(rank: int, nprocs: int) -> int:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qwen3_tts_tpu.parallel import mesh as mesh_lib
    from qwen3_tts_tpu.parallel import run as prun

    mesh_lib.initialize_multihost(
        coordinator=f"127.0.0.1:{PORT}", num_processes=nprocs, process_id=rank)
    n = len(jax.devices())
    print(f"[rank {rank}] global devices: {n}, local: "
          f"{len(jax.local_devices())}", flush=True)
    assert n == 4 * nprocs, "global device view incomplete"

    # data axis spans hosts, model axis within a host
    mesh = mesh_lib.make_mesh(nprocs, 4)
    cfg = prun.parallel_test_config(max_steps=2)
    models, voc = prun.build_sharded_models(mesh, cfg, seed=0)
    wav, n_frames = prun.sharded_generate_step(
        mesh, cfg, models, voc, batch=nprocs, prompt_len=4, max_steps=2)
    import numpy as np

    local = np.asarray(jax.experimental.multihost_utils.process_allgather(
        n_frames, tiled=True))
    print(f"[rank {rank}] n_frames (allgathered): {local.tolist()}",
          flush=True)
    print(f"[rank {rank}] MULTIHOST SMOKE OK", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    args = ap.parse_args()
    if args.rank is not None:
        return worker(args.rank, args.nprocs)

    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r),
             "--nprocs", str(args.nprocs)],
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        for r in range(args.nprocs)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    print("multihost smoke:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
