"""Benchmark: fused sensor-frames/sec/card on batched mapping replay.

B independent flight replays, each frame doing beam extraction + gating
+ a fused map update, on one GPU (the run fails without one).

By default prints SIX JSON lines {"metric", "value", "unit",
"vs_baseline", "checksum", "platform", "device_kind", "device_count",
"gpu"}: first `xla` — the BIT-EXACT reference-semantics replay (grids
bit-match the golden C model) — then `hybrid`, the PRODUCTION mode
(dense free-space carve + the reference's exact endpoint occupied
semantics; occ-IoU floors vs the exact path in tests/test_conemode.py),
then SLAM at the accuracy defaults (B=128), SLAM at the UL_RT throughput
operating point (B=256), EKF fusion, and the closed-loop swarm
simulator (MQS_BENCH_FULL=0 restores the two-line mapping-only bench).
vs_baseline is the multiple of the reference pipeline's own fused-frame
rate (~10 frames/s on the companion SBC, BASELINE.md).  "gpu" is the
card's name and power limit as nvidia-smi reports them.

Env knobs: MQS_BENCH_B (batch, default 1024), MQS_BENCH_T (frames/log,
default 256), MQS_BENCH_REPS (timed reps, default 3),
MQS_BENCH_MODE=replay|swarm|slam|ekf (default replay; swarm =
closed-loop simulator, BASELINE config 5: quads x 1 kHz control ticks;
MQS_BENCH_VF=1 adds real rendered-camera LK vision flow in the loop),
MQS_BENCH_KERNEL=xla|hybrid|cone|mxu|mxu2 pins a single replay
map-update kernel (one line).
"""

import json
import os
import sys
import time

import numpy as np


def _device_fields() -> dict:
    """Where the numbers were measured: JAX's device and the card."""
    import jax
    from micro_quad_slam_tpu.utils.device import gpu_name_and_power_limit

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit()[0]}


def _checksum(x) -> int:
    import jax.numpy as jnp
    return int(np.asarray(jnp.sum(x.astype(jnp.int32))))


def _time(run, reps: int):
    """Warm-up call, then `reps` timed calls each ending in
    block_until_ready.  Returns (best seconds, last output)."""
    import jax

    out = jax.block_until_ready(run())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return min(times), out


def bench_swarm(B: int, T: int, reps: int) -> None:
    import jax
    from micro_quad_slam_tpu.models.simulator import make_world, sim_init, sim_run
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    world = make_world(B, room=(-3.5, -3.5, 3.5, 3.5),
                       obstacles=[(1.5, -0.5, 2.5, 0.5)])
    # mid-mission start: armed + EXPLORE + mapper inited, so the 100 ms
    # scan ticks run REAL map updates from t=0 (a ground start spends the
    # whole 1 s window in ARMING/TAKEOFF with mapping disabled)
    st0 = sim_init(B, jax.random.PRNGKey(0), spread_m=0.5, airborne=True)
    # 1 kHz control ticks; ToF scans every 100 ms as in the reference
    vf = os.environ.get("MQS_BENCH_VF", "0") == "1"
    run = lambda: sim_run(st0, world, T, UL_PROFILE, dt_ms=1,
                          scan_period_ms=100, vision_flow=vf)[0]
    dt, st = _time(run, reps)
    checksum = _checksum(st.mapper.grid)
    tps = B * T / dt
    print(json.dumps({
        "metric": "swarm_control_ticks_per_sec_per_chip",
        "value": round(tps, 1),
        "unit": "quad-ticks/s",
        # north star: 1024 quads at 1 kHz = 1.024M quad-ticks/s
        "vs_baseline": round(tps / 1.024e6, 3),
        "checksum": checksum,
        **_device_fields(),
    }))
    print(f"# swarm B={B} T={T} best={dt*1e3:.1f} ms checksum={checksum}",
          file=sys.stderr)


def bench_slam(B: int, T: int, reps: int, profile: str = "acc") -> None:
    """Full SLAM replay (odo -> pass1 match -> loop closure -> pose graph
    -> re-raster) frames/s.  profile: "acc" = UL_PROFILE accuracy
    defaults; "rt" = UL_RT_PROFILE throughput operating point (single
    global round)."""
    from micro_quad_slam_tpu.sim import slam_bench_frames
    from micro_quad_slam_tpu.slam.pipeline import slam_replay
    from micro_quad_slam_tpu.utils.config import UL_PROFILE, UL_RT_PROFILE

    prof = UL_RT_PROFILE if profile == "rt" else UL_PROFILE
    bd = slam_bench_frames(B, T)
    dt, res = _time(lambda: slam_replay(bd, prof), reps)
    print(json.dumps({
        "metric": ("slam_frames_per_sec_per_chip" if profile == "acc"
                   else "slam_rt_frames_per_sec_per_chip"),
        "value": round(B * T / dt, 1),
        "unit": "frames/s",
        "vs_baseline": round(B * T / dt / 10.0, 1),  # ref fused rate
        "checksum": _checksum(res.grid),
        **_device_fields(),
    }))
    print(f"# slam[{profile}] B={B} T={T} best={dt*1e3:.1f} ms",
          file=sys.stderr)


def bench_ekf(B: int, T: int, reps: int) -> None:
    """EKF fusion replay frames/s."""
    import jax
    from micro_quad_slam_tpu.replay.fusion import _ekf_replay_batched
    from micro_quad_slam_tpu.sim import slam_bench_frames
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    bd = slam_bench_frames(B, T)
    fn = jax.jit(lambda f: _ekf_replay_batched(f, UL_PROFILE)[1]["x"])
    dt, out = _time(lambda: fn(bd), reps)
    print(json.dumps({
        "metric": "ekf_frames_per_sec_per_chip",
        "value": round(B * T / dt, 1),
        "unit": "frames/s",
        "vs_baseline": round(B * T / dt / 10.0, 1),
        "checksum": _checksum(out),
        **_device_fields(),
    }))
    print(f"# ekf B={B} T={T} best={dt*1e3:.1f} ms", file=sys.stderr)


def main() -> None:
    from micro_quad_slam_tpu.utils.device import (configure_compile_cache,
                                                  require_gpu)

    configure_compile_cache()
    require_gpu()
    mode = os.environ.get("MQS_BENCH_MODE", "replay")
    if mode == "swarm":
        bench_swarm(int(os.environ.get("MQS_BENCH_B", "1024")),
                    int(os.environ.get("MQS_BENCH_T", "1000")),
                    int(os.environ.get("MQS_BENCH_REPS", "2")))
        return
    if mode == "slam":
        bench_slam(int(os.environ.get("MQS_BENCH_B", "128")),
                   int(os.environ.get("MQS_BENCH_T", "256")),
                   int(os.environ.get("MQS_BENCH_REPS", "3")))
        return
    if mode == "ekf":
        bench_ekf(int(os.environ.get("MQS_BENCH_B", "1024")),
                  int(os.environ.get("MQS_BENCH_T", "256")),
                  int(os.environ.get("MQS_BENCH_REPS", "3")))
        return
    from micro_quad_slam_tpu.parallel.mesh import (
        _replay_batched_with_metrics,
        make_mesh,
        shard_batch,
    )
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.sim import replay_bench_frames
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    B = int(os.environ.get("MQS_BENCH_B", "1024"))
    T = int(os.environ.get("MQS_BENCH_T", "256"))
    reps = int(os.environ.get("MQS_BENCH_REPS", "3"))
    frames = shard_batch(replay_bench_frames(B, T), make_mesh())

    ref_fps = 10.0  # reference fused-frame rate (BASELINE.md)
    # Default: bench BOTH the bit-exact path (xla, the headline first
    # line) and the hybrid production path so the record carries both
    # numbers; MQS_BENCH_KERNEL pins one.
    pinned = os.environ.get("MQS_BENCH_KERNEL")
    kernels = [pinned] if pinned else ["xla", "hybrid"]
    for kernel in kernels:
        dt, (state, _, metrics) = _time(
            lambda: _replay_batched_with_metrics(frames, UL_PROFILE,
                                                 DEFAULT_GEOM, kernel),
            reps)
        checksum = _checksum(state.grid)
        fps = B * T / dt
        print(json.dumps({
            "metric": ("fused_sensor_frames_per_sec_per_chip" if kernel ==
                       kernels[0] else
                       f"fused_sensor_frames_per_sec_per_chip_{kernel}"),
            "value": round(fps, 1),
            "unit": "frames/s",
            "vs_baseline": round(fps / ref_fps, 1),
            "kernel": kernel,
            "exact": kernel in ("xla", "mxu", "mxu2"),
            "checksum": checksum,
            **_device_fields(),
        }))
        print(
            f"# kernel={kernel} B={B} T={T} reps={reps} best={dt*1e3:.1f} ms "
            f"frames_used={int(metrics['frames_used'])}/"
            f"{int(metrics['frames_total'])} grid_checksum={checksum}",
            file=sys.stderr,
        )

    # subsystem lines: SLAM, EKF fusion, and closed-loop swarm
    # throughput.  MQS_BENCH_FULL=0 restores the two-line mapping bench.
    if os.environ.get("MQS_BENCH_FULL", "1") == "1" and not pinned:
        bench_slam(int(os.environ.get("MQS_BENCH_SLAM_B", "128")), T,
                   max(reps - 1, 1))
        bench_slam(int(os.environ.get("MQS_BENCH_SLAM_RT_B", "256")), T,
                   max(reps - 1, 1), profile="rt")
        bench_ekf(int(os.environ.get("MQS_BENCH_EKF_B", "1024")), T,
                  max(reps - 1, 1))
        bench_swarm(int(os.environ.get("MQS_BENCH_SWARM_B", "1024")),
                    int(os.environ.get("MQS_BENCH_SWARM_T", "1000")),
                    max(reps - 1, 1))


if __name__ == "__main__":
    main()
