"""Smoke run of the system's main paths on one GPU.

Drives the mapping replay (exact and hybrid), the `mqs` CLI, SLAM (the
accuracy and real-time profiles, then the fig-8 high-drift scenario),
EKF fusion and the closed-loop swarm through their normal entry points
at the deployment sizes bench.py names, and checks every result by the
repo's own means: bit-equality with the golden model and with the same
function on the CPU backend, the hybrid map's IoU floors, and the SLAM
accuracy bars.  Nothing falls back: without a GPU the script exits
non-zero before any phase, and a phase that fails stops the run with a
non-zero exit.

Each phase prints one JSON line (card name and power limit, compile
seconds, the median of 3 warm runs each ending in block_until_ready,
peak_bytes_in_use since the process started, the check).  The last
line is {"ok": true, "device": {"platform", "kind", "count"}}.

    python chip_smoke.py               # one card, all phases
    python chip_smoke.py --devices 4   # only the sharded-vs-one-card phase
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# EKF positions, GPU vs CPU: float32 with another summation and FMA
# order.  Positions are metres in a few-metre room, where one float32
# ulp is ~1.2e-7 m; 1e-6 m allows a few ulps (an H100 measured 1.04e-7).
EKF_DPOS_M = 1e-6

# JAX's own trace, lowering and backend-compile durations
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


def _load_package():
    """The package must sit beside this script: the smoke run checks this
    checkout, not an installed copy."""
    try:
        import micro_quad_slam_tpu
    except ImportError as e:
        raise SystemExit(f"chip_smoke.py: micro_quad_slam_tpu is not "
                         f"beside this script ({e})")
    where = Path(micro_quad_slam_tpu.__file__).resolve().parents[1]
    if where != HERE:
        raise SystemExit(f"chip_smoke.py: micro_quad_slam_tpu imported "
                         f"from {where}, not from {HERE}")


class Smoke:
    """One smoke run's device, CPU reference device and compile clock.
    Use as a context manager: it listens to JAX's compile events while
    open."""

    def __init__(self, device, gpu: str):
        import jax

        self.device = device
        self.cpu = jax.devices("cpu")[0]
        self.gpu = gpu
        self.compile_s = 0.0

    def _on_event(self, event: str, duration_secs: float, **_):
        if event in _COMPILE_EVENTS:
            self.compile_s += duration_secs

    def __enter__(self):
        import jax
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self._on_event)

    def put(self, frames: dict, device=None) -> dict:
        import jax
        return {k: jax.device_put(v, device or self.device)
                for k, v in frames.items()}

    def timed(self, run, reps: int = 3):
        """First call (trace + compile + run), then `reps` warm calls,
        each ending in block_until_ready.  Returns (output, timings)."""
        import jax

        c0 = self.compile_s
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        first = time.perf_counter() - t0
        compile_s = self.compile_s - c0
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run())
            warm.append(time.perf_counter() - t0)
        return out, {"compile_s": compile_s, "first_call_s": first,
                     "warm_median_s": statistics.median(warm),
                     "warm_s": warm}


def _bit_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _first_diff(a, b):
    """Index of the first element where two same-shape arrays differ
    bitwise (None when equal)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    idx = np.argwhere(a != b)
    return None if idx.size == 0 else [int(i) for i in idx[0]]


class _Flight:
    """One row of a [B, T] frames batch, in the form
    golden_replay_mapping reads."""

    def __init__(self, frames: dict, i: int):
        for k, v in frames.items():
            setattr(self, k, v[i])

    def __len__(self):
        return len(self.x_m)


def _replay_frames(B: int, T: int) -> dict:
    """bench.py's replay workload with its last 8 flights drifting 34 m
    east and 21 m south, past the 15 m recenter threshold."""
    from micro_quad_slam_tpu.sim import replay_bench_frames

    frames = replay_bench_frames(B, T)
    drift = np.linspace(0.0, 34.0, T, dtype=np.float32)
    frames["x_m"][B - 8:] += drift
    frames["y_m"][B - 8:] -= drift * np.float32(0.62)
    return frames


def phase_replay(ctx: Smoke, B: int = 1024, T: int = 256,
                 n_golden: int = 8, n_cpu: int = 64) -> dict:
    """Exact and hybrid replay at B x T.  Exact grids bit-match the golden
    model on the first n_golden flights and the 8 drifting ones; both
    kernels bit-match the CPU backend on the last n_cpu flights (n_cpu >
    8); hybrid meets the occ-IoU 0.95 / free-IoU 0.60 floors of
    tests/test_conemode.py against exact on the workload flights of that
    slice.  The drifting flights carry the hover flight's scans at poses
    34 m away — an inconsistent map, so their IoU is reported, not
    held to the floors."""
    from micro_quad_slam_tpu.golden import golden_replay_mapping
    from micro_quad_slam_tpu.ops import logical_grid
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.replay.mapping import replay_mapping_batched
    from micro_quad_slam_tpu.utils.config import UL_PROFILE
    from micro_quad_slam_tpu.utils.obs import map_divergence

    frames = _replay_frames(B, T)
    on_dev = ctx.put(frames)
    tail = slice(B - n_cpu, B)
    on_cpu = ctx.put({k: v[tail] for k, v in frames.items()}, ctx.cpu)
    fields = lambda st, outs, sl: {
        "grid": st.grid[sl], "origin_x": st.origin_x[sl],
        "origin_y": st.origin_y[sl], "filt": st.filt[sl],
        "used": outs["used"][sl], "kf_flags": outs["kf_flags"][sl]}
    runs, check, maps = {}, {}, {}
    for kernel in ("xla", "hybrid"):
        (st, outs), runs[kernel] = ctx.timed(
            lambda: replay_mapping_batched(on_dev, UL_PROFILE, DEFAULT_GEOM,
                                           kernel))
        got = fields(st, outs, tail)
        want = fields(*replay_mapping_batched(on_cpu, UL_PROFILE,
                                              DEFAULT_GEOM, kernel),
                      slice(None))
        diffs = {k: _first_diff(got[k], want[k]) for k in got
                 if not _bit_equal(got[k], want[k])}
        check[f"{kernel}_vs_cpu_flights"] = n_cpu
        check[f"{kernel}_vs_cpu_first_diff"] = diffs
        maps[kernel] = np.asarray(logical_grid(got["grid"]))
        if kernel == "xla":
            idx = list(range(n_golden)) + list(range(B - 8, B))
            grids = np.asarray(logical_grid(st.grid[np.asarray(idx)]))
            used = np.asarray(outs["used"])[idx]
            bad = []
            for j, i in enumerate(idx):
                mapper, used_g = golden_replay_mapping(_Flight(frames, i))
                if not (_bit_equal(grids[j], mapper.grid)
                        and _bit_equal(used[j], used_g)):
                    bad.append({"flight": i,
                                "cell": _first_diff(grids[j], mapper.grid),
                                "used_frame": _first_diff(used[j], used_g)})
            check["golden_flights"] = idx
            check["golden_mismatch"] = bad
            check["recenters_on_drift_flights"] = int(
                (np.asarray(outs["kf_flags"])[B - 8:] != 0).sum())
    div = [map_divergence(e, h) for e, h in zip(maps["xla"], maps["hybrid"])]
    n_work = n_cpu - 8                      # workload flights in the slice
    check["hybrid_min_iou_occupied"] = min(d["iou_occupied"]
                                           for d in div[:n_work])
    check["hybrid_min_iou_free"] = min(d["iou_free"] for d in div[:n_work])
    check["hybrid_min_touched_cells"] = min(d["touched_cells"]
                                            for d in div[:n_work])
    check["drift_flights_min_iou"] = [
        min(d["iou_occupied"] for d in div[n_work:]),
        min(d["iou_free"] for d in div[n_work:])]
    ok = (not check["xla_vs_cpu_first_diff"]
          and not check["hybrid_vs_cpu_first_diff"]
          and not check["golden_mismatch"]
          and check["recenters_on_drift_flights"] > 0
          and check["hybrid_min_iou_occupied"] >= 0.95
          and check["hybrid_min_iou_free"] >= 0.60
          and check["hybrid_min_touched_cells"] > 500)
    return {"phase": "replay", "B": B, "T": T, "ok": ok, "runs": runs,
            "check": check}


def phase_cli(ctx: Smoke, frames: int = 200) -> dict:
    """`mqs synth` then `mqs --platform <this device> replay --kernel
    hybrid` in-process (first call, then 3 warm calls); the saved map
    must hold occupied and free cells."""
    from micro_quad_slam_tpu import cli
    from micro_quad_slam_tpu.io import native_available

    with tempfile.TemporaryDirectory() as d:
        log, out = os.path.join(d, "flight.bin"), os.path.join(d, "map.npy")
        argv = ["--platform", ctx.device.platform, "replay", "--log", log,
                "--kernel", "hybrid", "--out", out]
        rcs = []

        def call():
            t0 = time.perf_counter()
            rcs.append(cli.main(argv))
            return time.perf_counter() - t0

        with contextlib.redirect_stdout(io.StringIO()):
            rcs.append(cli.main(["synth", "--out", log, "--frames",
                                 str(frames), "--path", "circle"]))
            c0 = ctx.compile_s
            first = call()
            compile_s = ctx.compile_s - c0
            warm = [call() for _ in range(3)]
        grid = np.load(out)
    check = {"rcs": rcs, "occupied": int((grid > 10).sum()),
             "free": int((grid < -10).sum()),
             "native_io_built": native_available()}
    ok = all(rc == 0 for rc in rcs) and check["occupied"] > 0 \
        and check["free"] > 0
    run = {"compile_s": compile_s, "first_call_s": first,
           "warm_median_s": statistics.median(warm), "warm_s": warm}
    return {"phase": "cli", "T": frames, "ok": ok, "runs": {"replay": run},
            "check": check}


def _tail_err(track, x, y, n: int = 20):
    """Per-flight mean position error (m) over the last n frames."""
    err = np.hypot(np.asarray(track)[..., 0] - x, np.asarray(track)[..., 1] - y)
    return err[:, -n:].mean(axis=1)


def phase_slam(ctx: Smoke, B_acc: int = 128, B_rt: int = 256,
               T: int = 256) -> dict:
    """slam_replay on the canonical SLAM workload at the accuracy profile
    (B_acc) and the real-time profile (B_rt): every flight's track is
    finite and its map holds walls.  The tail errors of the SLAM and
    odometry tracks against the logged poses are reported; the accuracy
    bars are held by phase_slam_fig8."""
    from micro_quad_slam_tpu.ops import logical_grid
    from micro_quad_slam_tpu.sim import slam_bench_frames
    from micro_quad_slam_tpu.slam import slam_replay
    from micro_quad_slam_tpu.utils.config import UL_PROFILE, UL_RT_PROFILE

    runs, check, ok = {}, {}, True
    for label, prof, B in (("acc", UL_PROFILE, B_acc),
                           ("rt", UL_RT_PROFILE, B_rt)):
        host = slam_bench_frames(B, T, device_put=False)
        bd = ctx.put(host)
        res, runs[label] = ctx.timed(lambda: slam_replay(bd, prof))
        track = np.asarray(res.track)
        slam_err = _tail_err(track, host["x_m"], host["y_m"])
        odo_err = _tail_err(res.odo_track, host["x_m"], host["y_m"])
        occupied = (np.asarray(logical_grid(res.grid)) > 10).sum(axis=(1, 2))
        check[label] = {"B": B, "finite": bool(np.isfinite(track).all()),
                        "min_occupied": int(occupied.min()),
                        "max_tail_err_m": float(slam_err.max()),
                        "max_odo_tail_err_m": float(odo_err.max())}
        ok &= check[label]["finite"] and check[label]["min_occupied"] > 20
    return {"phase": "slam", "T": T, "ok": bool(ok), "runs": runs,
            "check": check}


def phase_slam_fig8(ctx: Smoke) -> dict:
    """The fig-8 high-drift scenario of tests/test_slam.py (12% flow-scale
    drift, seed 5): tail error <= 5 cm and wall IoU >= 0.85."""
    from micro_quad_slam_tpu.ops import logical_grid
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.replay.fusion import fusion_arrays
    from micro_quad_slam_tpu.replay.mapping import scanlog_to_arrays
    from micro_quad_slam_tpu.sim import synth_room_scanlog
    from micro_quad_slam_tpu.slam import slam_replay
    from micro_quad_slam_tpu.utils.config import UL_PROFILE
    from micro_quad_slam_tpu.utils.obs import map_iou_vs_walls

    room = (-2.5, -2.5, 2.5, 2.5)
    log = synth_room_scanlog(n_frames=160, path="fig8", path_radius_m=1.4,
                             room=room, with_flow=True, seed=5)
    log.of_rate_x[:] *= 1.12
    log.of_rate_y[:] *= 1.12
    f = {**scanlog_to_arrays(log), **fusion_arrays(log)}
    frames = ctx.put({k: v[None] for k, v in f.items()})
    res, run = ctx.timed(
        lambda: slam_replay(frames, UL_PROFILE, DEFAULT_GEOM, 10, 8))
    tail = float(_tail_err(res.track, log.x_m[None], log.y_m[None])[0])
    iou = map_iou_vs_walls(np.asarray(logical_grid(res.grid))[0],
                           float(res.origin[0][0]), float(res.origin[1][0]),
                           room)
    check = {"tail_err_m": tail, "wall_iou": iou}
    return {"phase": "slam_fig8", "T": 160, "ok": tail <= 0.05 and iou >= 0.85,
            "runs": {"fig8": run}, "check": check}


def phase_ekf(ctx: Smoke, B: int = 1024, T: int = 256,
              n_cpu: int = 64) -> dict:
    """EKF fusion replay at B x T; positions agree with the CPU backend
    on n_cpu flights within EKF_DPOS_M."""
    import jax
    from micro_quad_slam_tpu.replay.fusion import _ekf_replay_batched
    from micro_quad_slam_tpu.sim import slam_bench_frames
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    host = slam_bench_frames(B, T, device_put=False)
    host.pop("grid_mm")
    fn = jax.jit(lambda f: _ekf_replay_batched(f, UL_PROFILE)[1])
    bd = ctx.put(host)
    track, run = ctx.timed(lambda: fn(bd))
    ref = fn(ctx.put({k: v[:n_cpu] for k, v in host.items()}, ctx.cpu))
    dpos = max(float(np.abs(np.asarray(track[k])[:n_cpu]
                            - np.asarray(ref[k])).max()) for k in ("x", "y"))
    finite = all(bool(np.isfinite(np.asarray(track[k])).all())
                 for k in ("x", "y"))
    return {"phase": "ekf", "B": B, "T": T,
            "ok": finite and dpos <= EKF_DPOS_M,
            "runs": {"ekf": run},
            "check": {"finite": finite, "cpu_flights": n_cpu,
                      "max_abs_dpos_m": dpos}}


def _swarm_inputs(B: int):
    """bench.py's swarm of B quads, airborne from t=0, on JAX's default
    device: (initial state, world)."""
    import jax
    from micro_quad_slam_tpu.models.simulator import make_world, sim_init

    world = make_world(B, room=(-3.5, -3.5, 3.5, 3.5),
                       obstacles=[(1.5, -0.5, 2.5, 0.5)])
    st0 = sim_init(B, jax.random.PRNGKey(0), spread_m=0.5, airborne=True)
    return st0, world


def _swarm(B: int, ticks: int):
    """A call running bench.py's swarm: 1 ms control ticks, a ToF scan
    every 100 ms."""
    from micro_quad_slam_tpu.models.simulator import sim_run
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    st0, world = _swarm_inputs(B)
    return lambda: sim_run(st0, world, ticks, UL_PROFILE, dt_ms=1,
                           scan_period_ms=100)


def phase_swarm(ctx: Smoke, B: int = 1024, ticks: int = 1000,
                n_cpu: int = 8, cpu_ticks: int = 300) -> dict:
    """Closed-loop swarm at B quads x ticks: the map checksum is non-zero.
    At n_cpu quads x cpu_ticks the per-tick behaviour states, the per-tick
    diagnostics and the final grids equal the CPU backend's; otherwise
    the first divergence (tick, quad) of each differing field is
    reported."""
    import jax
    import jax.numpy as jnp

    (st, _), run = ctx.timed(_swarm(B, ticks))
    checksum = int(jnp.sum(st.mapper.grid.astype(jnp.int32)))
    st_g, diag_g = jax.block_until_ready(_swarm(n_cpu, cpu_ticks)())
    with jax.default_device(ctx.cpu):
        st_c, diag_c = _swarm(n_cpu, cpu_ticks)()
    got = {**{f"diag.{k}": v for k, v in diag_g.items()},
           "grid": st_g.mapper.grid, "beh.st": st_g.beh.st}
    want = {**{f"diag.{k}": v for k, v in diag_c.items()},
            "grid": st_c.mapper.grid, "beh.st": st_c.beh.st}
    diffs = {k: _first_diff(got[k], want[k]) for k in got
             if not _bit_equal(got[k], want[k])}
    check = {"map_checksum": checksum, "cpu_quads": n_cpu,
             "cpu_ticks": cpu_ticks, "vs_cpu_first_diff": diffs}
    ok = checksum != 0 and not any(
        k in diffs for k in ("diag.state", "beh.st", "grid"))
    return {"phase": "swarm", "B": B, "ticks": ticks, "ok": ok,
            "runs": {"swarm": run}, "check": check}


def phase_sharded(ctx: Smoke, n_devices: int, B_replay: int = 4096,
                  B_slam: int = 512, B_ekf: int = 4096,
                  B_swarm: int = 4096, T: int = 256,
                  ticks: int = 1000) -> dict:
    """parallel/mesh.py's data-parallel paths over a 1-D mesh of
    n_devices cards — replay (xla and hybrid), EKF fusion, SLAM and the
    swarm — each compared bit-for-bit with the same batch unsharded on
    the first card.  Each sharded path runs once (first_call_s includes
    its compile)."""
    import jax
    from micro_quad_slam_tpu.models.simulator import sim_run
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.parallel import (
        make_mesh, replay_fusion_sharded, replay_mapping_sharded,
        sim_run_sharded, slam_replay_sharded)
    from micro_quad_slam_tpu.replay.fusion import replay_fusion_batched
    from micro_quad_slam_tpu.replay.mapping import replay_mapping_batched
    from micro_quad_slam_tpu.sim import slam_bench_frames
    from micro_quad_slam_tpu.slam import slam_replay
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    mesh = make_mesh(n_devices)
    runs, diffs = {}, {}

    def once(name, run):
        c0 = ctx.compile_s
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        runs[name] = {"first_call_s": time.perf_counter() - t0,
                      "compile_s": ctx.compile_s - c0}
        return out

    def check(name, sharded, unsharded, pick):
        """Run both sides, keep only the first differing index of each
        field that is not bit-equal (the arrays are freed on return)."""
        got, want = pick(once(name, sharded)), pick(unsharded())
        d = {k: {"first": _first_diff(got[k], want[k]),
                 "max_abs": float(np.nanmax(np.abs(
                     np.asarray(got[k], np.float64)
                     - np.asarray(want[k], np.float64))))}
             for k in got if not _bit_equal(got[k], want[k])}
        if d:
            diffs[name] = d

    frames = _replay_frames(B_replay, T)
    for kernel in ("xla", "hybrid"):
        check(f"replay_{kernel}",
              lambda: replay_mapping_sharded(frames, UL_PROFILE, mesh,
                                             kernel=kernel)[:2],
              lambda: replay_mapping_batched(ctx.put(frames), UL_PROFILE,
                                             DEFAULT_GEOM, kernel),
              lambda r: {**r[0]._asdict(), **r[1]})

    fus = slam_bench_frames(B_ekf, T, device_put=False)
    fus.pop("grid_mm")
    check("ekf", lambda: replay_fusion_sharded(fus, UL_PROFILE, mesh),
          lambda: replay_fusion_batched(ctx.put(fus), UL_PROFILE),
          lambda r: {"mean": r[0].mean, "cov": r[0].cov, **r[1]})

    sf = slam_bench_frames(B_slam, T, device_put=False)
    kf, gn = UL_PROFILE.slam.kf_every, UL_PROFILE.slam.gn_iters
    check("slam", lambda: slam_replay_sharded(sf, UL_PROFILE, mesh,
                                              kf_every=kf, gn_iters=gn),
          lambda: slam_replay(ctx.put(sf), UL_PROFILE, DEFAULT_GEOM, kf, gn),
          lambda r: {"grid": r.grid, "track": r.track,
                     "kf_nodes": r.kf_nodes, "gn_costs": r.gn_costs})

    st0, world = _swarm_inputs(B_swarm)
    check("swarm", lambda: sim_run_sharded(st0, world, ticks, UL_PROFILE,
                                           mesh, dt_ms=1, scan_period_ms=100),
          lambda: sim_run(st0, world, ticks, UL_PROFILE, dt_ms=1,
                          scan_period_ms=100),
          lambda r: {"grid": r[0].mapper.grid, "x": r[0].x,
                     **{f"diag.{k}": v for k, v in r[1].items()}})

    return {"phase": "sharded", "devices": n_devices,
            "B": {"replay": B_replay, "slam": B_slam, "ekf": B_ekf,
                  "swarm": B_swarm},
            "T": T, "ticks": ticks, "ok": not diffs, "runs": runs,
            "check": {"bit_equal_to_one_card": not diffs,
                      "first_diff": diffs}}


PHASES = (phase_replay, phase_cli, phase_slam, phase_slam_fig8, phase_ekf,
          phase_swarm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="with N > 1, run only the sharded phase on N cards")
    args = ap.parse_args(argv)
    _load_package()

    import jax

    # the CPU backend computes the references; keep it when the
    # environment names only the accelerator (the first platform listed
    # stays JAX's default)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")

    from micro_quad_slam_tpu.utils.device import (
        configure_compile_cache, gpu_name_and_power_limit, require_gpu)

    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    n = len(jax.devices())
    if n < args.devices or any(d.platform != "gpu"
                               for d in jax.devices()[:args.devices]):
        print(f"chip_smoke.py: --devices {args.devices} needs that many "
              f"GPUs; JAX sees {jax.devices()}", file=sys.stderr)
        return 2
    configure_compile_cache()
    cards = gpu_name_and_power_limit()
    for line in cards:
        print(line, flush=True)
    with Smoke(dev, cards[0]) as ctx:
        if args.devices > 1:
            phases = (lambda c: phase_sharded(c, args.devices),)
        else:
            phases = PHASES
        for phase in phases:
            rec = phase(ctx)
            rec["gpu"] = ctx.gpu
            rec["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
                "peak_bytes_in_use")
            print(json.dumps(rec), flush=True)
            if not rec["ok"]:
                return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
