"""mqs — command line interface.

  mqs replay  --log scanlog.bin [more.bin ...] | --wirecap cap.bin
              [--kernel ...] [--sharded] [--save-state CK] [--resume CK]
              [--out map.npy] [--pgm map.pgm] [--ascii]
  mqs fusion  --log scanlog.bin | --wirecap cap.bin  [--out track.csv]
  mqs slam    --log scanlog.bin | --wirecap cap.bin  [--kf-every 10]
              [--out map.npy] [--pgm map.pgm] [--track track.csv]
  mqs sim     [--quads 16] [--seconds 20] [--out-prefix sim]
  mqs synth   --out scanlog.bin [--frames 200] [--path circle|hover|line]
  mqs bench   [replay|swarm]
  mqs info

Replay/SLAM consume the reference's scanlog.bin format
(uav_local_nav.c:1522-1547) via the native decoder when available.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _profile(name: str):
    from micro_quad_slam_tpu.utils.config import CL_PROFILE, UL_PROFILE
    return CL_PROFILE if name == "cl" else UL_PROFILE


def _load_log(path: str):
    from micro_quad_slam_tpu.io import read_scanlog_native
    return read_scanlog_native(path)


def _stack_logs(paths):
    """Load N scanlogs and stack them into one [B, T, ...] frames batch.

    Mixed lengths pad to the longest log with frames the mapper provably
    skips: NaN pose fails both map-init (`pose_finite`) and the
    pose_good gate (replay/mapping.py), and an all-zero ToF grid has no
    valid beams — so each flight's map is bit-identical to its solo
    replay (asserted in tests/test_replay.py).  Returns (logs, frames,
    per-log true lengths)."""
    from micro_quad_slam_tpu.replay import scanlog_to_arrays

    logs = [_load_log(p) for p in paths]
    arrs = [scanlog_to_arrays(lg) for lg in logs]
    lens = [a["x_m"].shape[0] for a in arrs]
    T = max(lens)
    nan_keys = ("x_m", "y_m", "yaw_deg", "of_rate_x")

    def pad(a, key):
        if a.shape[0] == T:
            return a
        fill = np.nan if key in nan_keys else 0
        tail = np.full((T - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail])

    frames = {k: np.stack([pad(a[k], k) for a in arrs]) for k in arrs[0]}
    return logs, frames, lens


def _indexed_path(path: str, i: int, n: int) -> str:
    if n == 1:
        return path
    stem, dot, ext = path.rpartition(".")
    return f"{stem}_{i}{dot}{ext}" if dot else f"{path}_{i}"


def _ascii_map(grid: np.ndarray, half: int = 40, step: int = 2) -> str:
    h, w = grid.shape
    cy, cx = h // 2, w // 2
    rows = []
    for r in range(cy - half, cy + half + 1, step):
        rows.append("".join(
            "#" if grid[r, c] > 10 else ("." if grid[r, c] < -10 else " ")
            for c in range(cx - half, cx + half + 1)))
    return "\n".join(rows)


def cmd_replay(args) -> int:
    from micro_quad_slam_tpu.ops import logical_grid
    from micro_quad_slam_tpu.replay.mapping import (
        mapping_init, replay_mapping_batched)
    if not args.wirecap and not args.log:
        print("one of --log / --wirecap is required", file=sys.stderr)
        return 2
    if args.wirecap:
        # live-topology replay: raw dual-UART capture (hub SCAN/CTRL +
        # FC MAVLink) through the same parser/telemetry stack
        from micro_quad_slam_tpu.replay.livestream import wirecap_to_frames
        from micro_quad_slam_tpu.formats.wirecap import read_wirecap
        raw = wirecap_to_frames(read_wirecap(args.wirecap))
        frames = {k: v[None] for k, v in raw.items()}
        log, lens = None, [raw["x_m"].shape[0]]
    else:
        logs, frames, lens = _stack_logs(args.log)
        log = logs[0] if len(logs) == 1 else None
    B = frames["x_m"].shape[0]
    state0 = None
    if args.resume:
        if args.sharded:
            print("--resume is not supported with --sharded",
                  file=sys.stderr)
            return 2
        from micro_quad_slam_tpu.utils.checkpoint import (
            latest_checkpoint, restore_checkpoint)
        path = latest_checkpoint(args.resume) or args.resume
        state0 = restore_checkpoint(path, like=mapping_init(B))
        print(f"resuming from {path}")
    if args.sharded:
        # fleet post-processing: shard the log batch over every visible
        # device (parallel/mesh.py) — same results, device-parallel
        import jax
        from micro_quad_slam_tpu.parallel import replay_mapping_sharded
        n_dev = len(jax.devices())
        if B % n_dev:
            print(f"--sharded needs the log count ({B}) to be a multiple "
                  f"of the device count ({n_dev})", file=sys.stderr)
            return 2
        state, outs, metrics = replay_mapping_sharded(
            frames, _profile(args.profile), kernel=args.kernel)
        print(f"sharded over {n_dev} devices: "
              f"{int(metrics['frames_used'])} of "
              f"{int(metrics['frames_total'])} frames mapped")
    else:
        state, outs = replay_mapping_batched(
            frames, _profile(args.profile), kernel=args.kernel,
            state0=state0)
    if args.save_state:
        from micro_quad_slam_tpu.utils.checkpoint import save_checkpoint
        import jax
        p = save_checkpoint(args.save_state,
                            jax.tree.map(np.asarray, state),
                            step=max(lens))
        print(f"mapper state -> {p}")
    for i in range(B):
        grid = np.asarray(logical_grid(state.grid[i]))
        used = int(np.asarray(outs["used"])[i, :lens[i]].sum())
        tag = f"[{i}] " if B > 1 else ""
        print(f"{tag}replayed {lens[i]} frames ({used} mapped); "
              f"occupied={int((grid > 10).sum())} "
              f"free={int((grid < -10).sum())} "
              f"origin=({float(state.origin_x[i]):.2f},"
              f"{float(state.origin_y[i]):.2f})")
        if args.out:
            p = _indexed_path(args.out, i, B)
            np.save(p, grid)
            print(f"{tag}map -> {p}")
        if args.pgm:
            from micro_quad_slam_tpu.utils.obs import save_map_pgm
            p = save_map_pgm(_indexed_path(args.pgm, i, B), grid,
                             trinary=not args.pgm_raw)
            print(f"{tag}map image -> {p}")
        if args.ascii and B > 1:
            print(_ascii_map(grid))
    grid = np.asarray(logical_grid(state.grid[0]))
    outs = {k: np.asarray(v)[0] for k, v in outs.items()}
    if args.navlog and log is None:
        print("--navlog requires a single scanlog input (--log)",
              file=sys.stderr)
        return 2
    if args.navlog:
        from micro_quad_slam_tpu.formats import NavlogWriter
        filt = np.asarray(outs["filt"])
        with NavlogWriter(args.navlog) as w:
            for i in range(len(log)):
                w.write_row(
                    int(log.host_ms[i]), int(log.state[i]), True, True, 4,
                    float(log.yaw_deg[i]), float(log.alt_m[i]), 2,
                    float(log.x_m[i]), float(log.y_m[i]),
                    float("nan"), float("nan"), float(log.rf_m[i]),
                    int(log.of_q[i]), float(log.of_rate_x[i]),
                    float(log.of_rate_y[i]), float(filt[i, 0]),
                    float(filt[i, 1]), float(filt[i, 2]), float(filt[i, 3]),
                    float("nan"), 0)
        print(f"navlog -> {args.navlog}")
    if args.ascii and B == 1:
        print(_ascii_map(grid))
    return 0


def cmd_fusion(args) -> int:
    from micro_quad_slam_tpu.replay.fusion import (
        fusion_arrays, pose_rmse, replay_fusion)

    if not args.wirecap and not args.log:
        print("one of --log / --wirecap is required", file=sys.stderr)
        return 2
    if args.wirecap:
        from micro_quad_slam_tpu.formats.wirecap import read_wirecap
        from micro_quad_slam_tpu.replay.livestream import wirecap_to_frames
        frames = wirecap_to_frames(read_wirecap(args.wirecap))
        n_frames = frames["x_m"].shape[0]
        log = None
    else:
        log = _load_log(args.log)
        frames = fusion_arrays(log)
        n_frames = len(log)
    state, track = replay_fusion(frames)
    rmse = pose_rmse(track, frames)
    used = int(np.asarray(track["flow_used"]).sum())
    print(f"EKF replay: {n_frames} frames, flow fused on {used}; "
          f"pose RMSE vs logged track: "
          f"{'n/a' if np.isnan(rmse) else f'{rmse * 100:.2f} cm'}")
    if args.out:
        scan_ms = np.asarray(frames["scan_ms"])
        with open(args.out, "w") as f:
            f.write("t_ms,x,y,z,vx,vy,vz,yaw_rad,flow_used\n")
            for i in range(n_frames):
                f.write(f"{int(scan_ms[i])},{float(track['x'][i]):.4f},"
                        f"{float(track['y'][i]):.4f},"
                        f"{float(track['z'][i]):.4f},"
                        f"{float(track['vx'][i]):.4f},"
                        f"{float(track['vy'][i]):.4f},"
                        f"{float(track['vz'][i]):.4f},"
                        f"{float(track['yaw'][i]):.4f},"
                        f"{int(track['flow_used'][i])}\n")
        print(f"track -> {args.out}")
    return 0


def _override_slam(slam_cfg, pairs):
    """Apply repeatable --slam-set key=value overrides to a SlamConfig,
    coercing each value to the field's declared type (bool accepts
    true/false/1/0)."""
    import dataclasses

    fields = {f.name: f.type for f in dataclasses.fields(slam_cfg)}
    upd = {}
    for pair in pairs:
        key, _, val = pair.partition("=")
        if key not in fields or not _:
            valid = ", ".join(sorted(fields))
            raise SystemExit(
                f"--slam-set {pair!r}: expected key=value with key one of "
                f"{valid}")
        cur = getattr(slam_cfg, key)
        if isinstance(cur, bool):
            if val.lower() not in ("true", "false", "1", "0"):
                raise SystemExit(f"--slam-set {key}: boolean, got {val!r}")
            upd[key] = val.lower() in ("true", "1")
        elif isinstance(cur, int):
            upd[key] = int(val)
        elif isinstance(cur, tuple):    # edge weights: x,y,yaw triple
            parts = tuple(float(v) for v in val.split(","))
            if len(parts) != len(cur):
                raise SystemExit(
                    f"--slam-set {key}: expected {len(cur)} "
                    f"comma-separated floats, got {val!r}")
            upd[key] = parts
        else:
            upd[key] = float(val)
    return dataclasses.replace(slam_cfg, **upd)


def cmd_slam(args) -> int:
    from micro_quad_slam_tpu.ops import logical_grid
    from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu.replay.fusion import fusion_arrays
    from micro_quad_slam_tpu.replay.mapping import scanlog_to_arrays
    from micro_quad_slam_tpu.slam import slam_replay

    if not args.wirecap and not args.log:
        print("one of --log / --wirecap is required", file=sys.stderr)
        return 2
    if args.wirecap:
        from micro_quad_slam_tpu.formats.wirecap import read_wirecap
        from micro_quad_slam_tpu.replay.livestream import wirecap_to_frames
        raw = wirecap_to_frames(read_wirecap(args.wirecap))
        n_frames = raw["x_m"].shape[0]
        x_truth, y_truth = raw["x_m"][None], raw["y_m"][None]
        frames = {k: v[None] for k, v in raw.items()}
    else:
        logs = [_load_log(p) for p in args.log]
        if len({len(lg) for lg in logs}) > 1:
            # padded frames would enter the keyframe graph as NaN nodes
            # and poison the GN solve; batched SLAM needs equal lengths
            print("mqs slam with several logs requires equal frame "
                  f"counts, got {[len(lg) for lg in logs]}",
                  file=sys.stderr)
            return 2
        log = logs[0]
        n_frames = len(log)
        x_truth = np.stack([lg.x_m for lg in logs])
        y_truth = np.stack([lg.y_m for lg in logs])
        dicts = [{**scanlog_to_arrays(lg), **fusion_arrays(lg)}
                 for lg in logs]
        frames = {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}
    state0 = None
    if args.resume:
        from micro_quad_slam_tpu.utils.checkpoint import (
            latest_checkpoint, restore_checkpoint)
        B = frames["x_m"].shape[0]
        like = (np.zeros((B, DEFAULT_GEOM.prows, DEFAULT_GEOM.pcols),
                         np.int8),
                np.zeros(B, np.float32), np.zeros(B, np.float32))
        path = latest_checkpoint(args.resume) or args.resume
        state0 = restore_checkpoint(path, like=like)
        print(f"resuming SLAM map from {path}")
    cfg = _profile(args.profile)
    if args.slam_set:
        cfg = cfg.replace(slam=_override_slam(cfg.slam, args.slam_set))
    res = slam_replay(frames, cfg, DEFAULT_GEOM,
                      args.kf_every, args.gn_iters, state0)
    if args.save_state:
        from micro_quad_slam_tpu.utils.checkpoint import save_checkpoint
        p = save_checkpoint(
            args.save_state,
            (np.asarray(res.grid), np.asarray(res.origin[0]),
             np.asarray(res.origin[1])), step=n_frames)
        print(f"slam map state -> {p}")
    B = frames["x_m"].shape[0]
    n_kf = len(np.asarray(res.kf_idx))
    for b in range(B):
        grid = np.asarray(logical_grid(res.grid))[b]
        tag = f"[{b}] " if B > 1 else ""
        msg = (f"{tag}SLAM: {n_frames} frames, {n_kf} keyframes; "
               f"occupied={int((grid > 10).sum())}")
        if np.isfinite(x_truth[b]).all():
            t = np.stack([x_truth[b], y_truth[b]], -1)
            oe = np.hypot(*(np.asarray(res.odo_track)[b, :, :2] - t).T).mean()
            se = np.hypot(*(np.asarray(res.track)[b, :, :2] - t).T).mean()
            msg += (f"; mean err vs logged track: odom {oe*100:.1f} cm -> "
                    f"slam {se*100:.1f} cm")
        print(msg)
        if args.out:
            p = _indexed_path(args.out, b, B)
            np.save(p, grid)
            print(f"{tag}corrected map -> {p}")
        if args.pgm:
            from micro_quad_slam_tpu.utils.obs import save_map_pgm
            p = save_map_pgm(_indexed_path(args.pgm, b, B), grid,
                             trinary=not args.pgm_raw)
            print(f"{tag}corrected map image -> {p}")
        if args.track:
            trk = np.asarray(res.track)[b]
            odo = np.asarray(res.odo_track)[b]
            scan_ms = np.asarray(frames["scan_ms"])[b]
            p = _indexed_path(args.track, b, B)
            with open(p, "w") as f:
                f.write("t_ms,x,y,yaw_rad,odo_x,odo_y,odo_yaw_rad\n")
                for i in range(n_frames):
                    f.write(f"{int(scan_ms[i])},{trk[i, 0]:.4f},"
                            f"{trk[i, 1]:.4f},{trk[i, 2]:.4f},"
                            f"{odo[i, 0]:.4f},{odo[i, 1]:.4f},"
                            f"{odo[i, 2]:.4f}\n")
            print(f"{tag}corrected track -> {p}")
        if args.ascii:
            print(_ascii_map(grid))
    return 0


def cmd_sim(args) -> int:
    import jax
    from micro_quad_slam_tpu.models.simulator import (
        make_world, sim_init, sim_run)
    from micro_quad_slam_tpu.ops import logical_grid
    from micro_quad_slam_tpu.utils.obs import STATE_NAMES_UL

    B = args.quads
    world = make_world(B, room=(-3.5, -3.5, 3.5, 3.5),
                       obstacles=[(1.5, -0.5, 2.5, 0.5)])
    st = sim_init(B, jax.random.PRNGKey(args.seed), spread_m=0.5)
    if args.resume:
        from micro_quad_slam_tpu.utils.checkpoint import (
            latest_checkpoint, restore_checkpoint)
        path = latest_checkpoint(args.resume) or args.resume
        st = jax.tree_util.tree_map(
            lambda like, v: jax.numpy.asarray(v, like.dtype),
            st, restore_checkpoint(path, like=st))
        print(f"resuming sim from {path}")
    steps = int(args.seconds * 1000 / args.dt_ms)
    record = bool(args.out_prefix) or bool(args.emit_mavlink)
    st, diag = sim_run(st, world, steps, _profile(args.profile),
                       dt_ms=args.dt_ms, record=record,
                       vision_flow=args.vision_flow)
    if args.save_state:
        from micro_quad_slam_tpu.utils.checkpoint import save_checkpoint
        p = save_checkpoint(args.save_state, st, step=steps)
        print(f"sim state -> {p}")
    states = np.asarray(diag["state"])[-1]
    from collections import Counter
    mix = Counter(STATE_NAMES_UL[s] for s in states)
    grids = np.asarray(logical_grid(st.mapper.grid))
    occ = (grids > 10).reshape(B, -1).sum(1)
    print(f"swarm {B} quads x {args.seconds}s: final states {dict(mix)}; "
          f"occupied cells/quad median={int(np.median(occ))}; "
          f"pose err max={float(np.asarray(diag['pose_err'])[-1].max()):.3f} m")
    if args.out_prefix:
        from micro_quad_slam_tpu.formats import write_scanlog
        from micro_quad_slam_tpu.models.simulator import sim_diag_to_scanlogs
        np.save(f"{args.out_prefix}_grids.npy", grids)
        print(f"grids -> {args.out_prefix}_grids.npy")
        logs = sim_diag_to_scanlogs(diag)
        for b, lg in enumerate(logs[:4]):
            write_scanlog(f"{args.out_prefix}_q{b}.bin", lg)
        print(f"scanlogs -> {args.out_prefix}_q*.bin "
              f"(first {min(4, len(logs))} quads)")
    if args.emit_mavlink:
        from micro_quad_slam_tpu.models.simulator import sim_diag_to_mavlink
        buf = sim_diag_to_mavlink(diag, quad=0)
        with open(args.emit_mavlink, "wb") as f:
            f.write(buf)
        print(f"quad 0 FC command stream ({len(buf)} bytes) -> "
              f"{args.emit_mavlink}")
    return 0


def cmd_synth(args) -> int:
    from micro_quad_slam_tpu.formats import write_scanlog
    from micro_quad_slam_tpu.sim import synth_room_scanlog

    log = synth_room_scanlog(
        n_frames=args.frames, path=args.path, path_radius_m=args.radius,
        room=tuple(args.room), with_flow=True, noise_mm=args.noise_mm,
        dropout_p=args.dropout, seed=args.seed)
    write_scanlog(args.out, log)
    print(f"synthetic flight ({args.frames} frames, {args.path}) -> {args.out}")
    if args.emit_wirecap:
        from micro_quad_slam_tpu.formats.wirecap import write_wirecap
        from micro_quad_slam_tpu.replay.livestream import scanlog_to_wirecap
        ver = 2 if args.mav2 else 1
        n = write_wirecap(args.emit_wirecap,
                          scanlog_to_wirecap(log, mav_version=ver))
        print(f"dual-UART capture ({n} records, MAVLink v{ver}) -> "
              f"{args.emit_wirecap}")
    return 0


def cmd_bench(args) -> int:
    import os
    if args.mode:
        os.environ["MQS_BENCH_MODE"] = args.mode
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    if spec is None or spec.loader is None:
        print("bench.py not found", file=sys.stderr)
        return 1
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return 0


def cmd_info(args) -> int:
    import jax
    import micro_quad_slam_tpu as mqs
    from micro_quad_slam_tpu.io import native_available

    print(json.dumps({
        "version": mqs.__version__,
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "native_io": native_available(),
        "profiles": ["ul", "cl"],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    from micro_quad_slam_tpu.replay.mapping import KERNELS

    p = argparse.ArgumentParser(prog="mqs", description=__doc__)
    p.add_argument("--platform", choices=("cpu", "gpu"),
                   help="pin the JAX platform (default: JAX's choice, a "
                        "GPU when one is present)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("replay", help="scanlog -> occupancy map")
    pr.add_argument("--log", nargs="+",
                    help="one or more scanlog.bin files; several logs "
                         "replay as ONE batched launch (mixed lengths "
                         "pad with gated-out frames, bit-identical per "
                         "log to a solo replay)")
    pr.add_argument("--sharded", action="store_true",
                    help="shard the log batch over all visible devices "
                         "(log count must divide evenly)")
    pr.add_argument("--wirecap", help="replay a raw dual-UART capture "
                                      "(hub SCAN/CTRL + FC MAVLink, "
                                      "formats/wirecap.py) instead of a "
                                      "scanlog")
    pr.add_argument("--out")
    pr.add_argument("--profile", default="ul", choices=("ul", "cl"))
    pr.add_argument("--kernel", default="xla",
                    choices=KERNELS,
                    help="map-update kernel: xla/mxu/mxu2 are bit-exact "
                         "reference semantics; cone is the dense "
                         "inverse-model mode; hybrid is the PRODUCTION "
                         "mode: dense free-space carve + the reference's "
                         "exact endpoint occupied semantics")
    pr.add_argument("--ascii", action="store_true")
    pr.add_argument("--pgm", help="write the map as a PGM image "
                                  "(occupied=black/free=white/unknown=gray)")
    pr.add_argument("--pgm-raw", action="store_true",
                    help="grayscale log-odds PGM instead of trinary")
    pr.add_argument("--navlog", help="write a reference-format navlog.csv "
                                     "of the replay")
    pr.add_argument("--save-state", help="checkpoint the final mapper state "
                                         "(resume a later log with --resume)")
    pr.add_argument("--resume", help="checkpoint dir/path to resume from "
                                     "(bit-identical to an unbroken replay)")
    pr.set_defaults(fn=cmd_replay)

    pf = sub.add_parser("fusion", help="EKF pose track from raw streams")
    pf.add_argument("--log")
    pf.add_argument("--wirecap", help="EKF replay from a raw dual-UART "
                                      "capture")
    pf.add_argument("--out")
    pf.set_defaults(fn=cmd_fusion)

    ps = sub.add_parser("slam", help="scan-matched + graph-refined map")
    ps.add_argument("--log", nargs="+",
                    help="one or more scanlog.bin files (equal frame "
                         "counts) — several logs SLAM as one batched "
                         "launch")
    ps.add_argument("--wirecap", help="SLAM from a raw dual-UART capture")
    ps.add_argument("--out")
    ps.add_argument("--profile", default="ul", choices=("ul", "cl"))
    ps.add_argument("--kf-every", type=int, default=10)
    ps.add_argument("--gn-iters", type=int, default=8)
    ps.add_argument("--slam-set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any SlamConfig field (repeatable), "
                         "e.g. --slam-set match_feedback=true "
                         "--slam-set match_iters=3")
    ps.add_argument("--ascii", action="store_true")
    ps.add_argument("--pgm", help="write the corrected map as a PGM image "
                                  "(occupied=black/free=white/unknown=gray)")
    ps.add_argument("--pgm-raw", action="store_true",
                    help="grayscale log-odds PGM instead of trinary")
    ps.add_argument("--track", help="write the corrected + odometry pose "
                                    "tracks as CSV")
    ps.add_argument("--save-state", help="checkpoint the corrected map + "
                                         "origins (continue a later "
                                         "segment with --resume)")
    ps.add_argument("--resume", help="checkpoint dir/path of a previous "
                                     "slam segment's map to continue in "
                                     "the same frame")
    ps.set_defaults(fn=cmd_slam)

    pm = sub.add_parser("sim", help="closed-loop swarm simulation")
    pm.add_argument("--quads", type=int, default=16)
    pm.add_argument("--seconds", type=float, default=20.0)
    pm.add_argument("--dt-ms", type=int, default=20)
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("--profile", default="ul", choices=("ul", "cl"))
    pm.add_argument("--out-prefix")
    pm.add_argument("--emit-mavlink",
                    help="write quad 0's MAVLink command stream to a file")
    pm.add_argument("--save-state", help="checkpoint the final sim state "
                                         "(continue with --resume)")
    pm.add_argument("--resume", help="checkpoint dir/path of a previous "
                                     "sim run to continue from")
    pm.add_argument("--vision-flow", action="store_true",
                    help="localize with REAL pyramidal LK optical flow on "
                         "rendered downward-camera frames instead of the "
                         "oracle flow sensor")
    pm.set_defaults(fn=cmd_sim)

    py = sub.add_parser("synth", help="generate a synthetic scanlog")
    py.add_argument("--out", required=True)
    py.add_argument("--frames", type=int, default=200)
    py.add_argument("--path", default="circle",
                    choices=("circle", "hover", "line", "fig8"))
    py.add_argument("--radius", type=float, default=1.0)
    py.add_argument("--room", type=float, nargs=4,
                    default=(-3.0, -3.0, 3.0, 3.0))
    py.add_argument("--noise-mm", type=float, default=5.0)
    py.add_argument("--dropout", type=float, default=0.02)
    py.add_argument("--seed", type=int, default=0)
    py.add_argument("--emit-wirecap", help="also write the flight as a raw "
                                           "dual-UART capture")
    py.add_argument("--mav2", action="store_true",
                    help="emit the wirecap FC channel as MAVLink v2 "
                         "(0xFD framing, like a real ArduPilot FC)")
    py.set_defaults(fn=cmd_synth)

    pb = sub.add_parser("bench", help="run the throughput benchmark")
    pb.add_argument("mode", nargs="?", choices=("replay", "swarm"))
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="environment / version info")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    import jax
    from micro_quad_slam_tpu.utils.device import configure_compile_cache

    configure_compile_cache()
    if args.platform:
        # takes effect only before JAX's first backend query; after it
        # (an in-process caller) the platform in use must already match
        jax.config.update("jax_platforms", args.platform)
        if jax.default_backend() != args.platform:
            print(f"--platform {args.platform}: JAX is already running on "
                  f"{jax.default_backend()}", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
