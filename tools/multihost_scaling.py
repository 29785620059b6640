#!/usr/bin/env python
"""Multi-host weak-scaling harness: audio-s/s at 1 vs 2 processes.

Measures the BASELINE north-star metric (>=90% audio-seconds/s scaling
1 -> 2 hosts) on the multi-host scaling design:

  * DP ACROSS hosts is HOST-LOCAL — each process builds a mesh over its
    own devices only (parallel/mesh.make_local_mesh) and runs its own
    fused generation program (while_loop -> vocoder) over its own
    utterances. The per-frame decode loop therefore contains NO
    cross-process collective; hosts touch each other only at the start
    barrier and the end-of-run result files.
  * TP stays WITHIN a process — the talker's psum/all-gather collectives
    stay on the host's own device links, never the network.
  * TP *across* hosts remains available via the global-mesh path
    (parallel/run.sharded_generate_step, exercised by --mode global and
    by the multichip dryrun) for models too large for one host.

Each host-analog is pinned to its OWN core set with one virtual CPU
device per core (on a real cluster: one host's cards — swap the env and
the same script is the cluster harness). The pinning is what makes the analog
fair: unpinned, the 1-process run owns the whole machine while the
2-process run fights for it, and the harness measures core contention
instead of the scaling design (that artifact was round 4's 0.078).
Weak scaling: per-host batch and per-host resources are constant, so
ideal scaling is equal wall time; efficiency compares aggregate
throughput at 2 processes against 2x the 1-process throughput, with the
2-process time taken as the SLOWEST process's (true wall clock between
the shared barrier and the last finisher).

Run:  python tools/multihost_scaling.py [--steps 8] [--reps 3]
      -> one JSON line {"throughput_1p":..., "throughput_2p":...,
                        "scaling_efficiency":...}

--mode global reproduces the round-4 design (one global mesh, data axis
across processes) whose per-frame all-rows-EOS reduction crosses the
process boundary every frame — kept for TP-across-hosts and as the
counter-measurement that motivated the host-local default.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_HOST_BATCH = 4
FRAME_S = 1.0 / 12.0


def _allowed_cpus():
    """This process's actual cpuset (cgroup/affinity aware) — deriving
    pin targets from os.cpu_count() crashes in restricted containers."""
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:                      # non-Linux
        return list(range(os.cpu_count() or 2))


def per_host_cores() -> int:
    """Cores per host-analog. A fair weak-scaling analog gives every
    simulated host its OWN cores: without pinning, the 1-process run owns
    the whole machine while the 2-process run fights for it, and the
    harness measures core contention (8 virtual devices' thread pools on
    this box's cores), not the scaling design."""
    return max(1, len(_allowed_cpus()) // 2)


def worker(rank: int, nprocs: int, port: int, steps: int, reps: int,
           out_path: str, mode: str) -> int:
    ncores = per_host_cores()
    # pin this host-analog to its own slice of the ALLOWED cpuset
    cpus = _allowed_cpus()
    mine = set(cpus[rank * ncores: (rank + 1) * ncores]) or set(cpus)
    try:
        os.sched_setaffinity(0, mine)
    except (AttributeError, OSError):
        pass                                    # unpinned analog still runs
    devs = ncores                       # one virtual device per pinned core
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs}")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qwen3_tts_tpu.parallel import mesh as mesh_lib
    from qwen3_tts_tpu.parallel import run as prun

    if nprocs > 1:
        mesh_lib.initialize_multihost(
            coordinator=f"127.0.0.1:{port}", num_processes=nprocs,
            process_id=rank)

    cfg = prun.parallel_test_config(max_steps=steps)
    if mode == "local":
        # host-local DP: this process's devices, this process's utterances;
        # the decode loop never crosses the process boundary
        mesh = mesh_lib.make_local_mesh(model=devs)
        batch = PER_HOST_BATCH
    else:
        # global mesh: data axis across processes (the round-4 design);
        # the while_loop's all-rows-EOS check syncs processes every frame
        mesh = mesh_lib.make_mesh(nprocs, devs)
        batch = PER_HOST_BATCH * nprocs
    models, voc = prun.build_sharded_models(mesh, cfg, seed=0)

    # local mode: each host draws its own utterances (rank-offset seeds);
    # global mode: ONE global program, inputs must be identical per process
    seed_off = 1000 * rank if mode == "local" else 0

    def step(seed):
        wav, n_frames = prun.sharded_generate_step(
            mesh, cfg, models, voc, batch=batch, prompt_len=16,
            max_steps=steps, seed=seed + seed_off)
        return jax.block_until_ready((wav, n_frames))

    step(0)                                    # compile + warm
    if nprocs > 1:
        # start-of-run barrier: the ONLY pre-result cross-process touch
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("scaling-warm")
    times, frames = [], 0
    t_all = time.perf_counter()
    for r in range(reps):
        t0 = time.perf_counter()
        _, n_frames = step(r + 1)
        times.append(time.perf_counter() - t0)
        frames += int(jax.numpy.sum(n_frames))
    elapsed = time.perf_counter() - t_all
    med = sorted(times)[len(times) // 2]
    audio_s = (frames / reps) * FRAME_S
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump({"rank": rank, "nprocs": nprocs, "median_s": med,
                   "elapsed_s": elapsed,
                   "audio_s_per_call": audio_s,
                   "throughput": audio_s / med}, f)
    return 0


def run_config(nprocs: int, port: int, steps: int, reps: int,
               mode: str) -> dict:
    out = tempfile.mktemp(suffix=".json")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r),
             "--nprocs", str(nprocs), "--port", str(port),
             "--steps", str(steps), "--reps", str(reps), "--out", out,
             "--mode", mode],
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        for r in range(nprocs)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    if rc != 0:
        raise RuntimeError(f"{nprocs}-process run failed (rc {rc})")
    ranks = []
    for r in range(nprocs):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    # aggregate: total audio per call across hosts over the SLOWEST
    # process's median call time (true wall clock past the barrier).
    # local mode: each rank ran its own batch -> sum; global mode: every
    # rank reports the same single global batch -> take one
    if mode == "local":
        audio = sum(r["audio_s_per_call"] for r in ranks)
    else:
        audio = ranks[0]["audio_s_per_call"]
    t = max(r["median_s"] for r in ranks)
    return {"nprocs": nprocs, "median_s": t, "audio_s_per_call": audio,
            "throughput": audio / t}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--port", type=int, default=29431)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", choices=("local", "global"), default="local")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return worker(args.rank, args.nprocs, args.port, args.steps,
                      args.reps, args.out, args.mode)

    r1 = run_config(1, args.port, args.steps, args.reps, args.mode)
    r2 = run_config(2, args.port + 1, args.steps, args.reps, args.mode)
    # weak scaling: per-host work is constant, so efficiency
    #   = throughput_2p / (2 * throughput_1p)
    eff = r2["throughput"] / (2.0 * r1["throughput"])
    print(json.dumps({
        "throughput_1p_audio_s_per_s": round(r1["throughput"], 3),
        "throughput_2p_audio_s_per_s": round(r2["throughput"], 3),
        "scaling_efficiency": round(eff, 3),
        "median_s_1p": round(r1["median_s"], 3),
        "median_s_2p": round(r2["median_s"], 3),
        "mode": args.mode,
        "per_host_cores": per_host_cores(),
        "note": "2 Gloo CPU processes, each pinned to its own core set "
                "with one virtual device per core (a fair weak-scaling "
                "analog: every simulated host owns its resources); "
                "host-local DP, no cross-process collective in the "
                "decode loop. Same harness drives a real pod slice." if
                args.mode == "local" else
                "global-mesh mode: data axis across processes; the "
                "per-frame EOS reduction crosses the process boundary "
                "(kept for TP-across-hosts).",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
