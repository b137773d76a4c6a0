"""Full SLAM replay (BASELINE.json config 4): scan-matching + pose-graph
Gauss-Newton loop closure over a complete flight, drift-corrected map.

The reference dead-reckons on the FC EKF's LOCAL_POSITION_NED and its map
silently smears under drift (SURVEY.md §7 step 7).  This pipeline adds the
missing back-end in three passes, all on-device:

  pass 1  (sequential over keyframe chunks): EKF odometry -> pose guess;
          on keyframe ticks, correlative scan-match against the map built
          so far (ops/scanmatch.py) corrects the guess before the fused
          raycast update.  The match map accumulates KEYFRAME scans only
          by default (SlamConfig.match_map_kf_only — it exists solely to
          localize against; pass 3 re-rasters every frame).  By default
          a match-free chunk scan builds the snapshot grids and every
          keyframe then matches in one flat batch (_map_pass_nofb); the
          feedback formulation runs a per-frame lax.scan (_map_pass).
  pass 2  (parallel): build an SE(2) pose graph per flight — odometry
          edges between consecutive keyframes + match-anchor edges +
          proximity-gated revisit loop edges — and run batched dense
          Gauss-Newton (slam/posegraph.py, Cholesky on the SPD normals).
  pass 3  (sequential over frames): re-raster the map from the
          corrected track.

The grid recenters exactly like the mapping replay when the pose strays
past the map threshold (uav_local_nav.c:308-353): the recenter schedule
is decided grid-free from the odometry track (the same decide/shift
scalars, ops/raycast.py:252-281), so the whole pipeline keeps static
shapes.  Without this, a long-excursion flight beyond ~21 m of the start
silently dropped rays.

Keyframe poses between graph nodes are corrected rigidly relative to the
owning keyframe (standard pose-graph interpolation).  All tunables live
in utils/config.SlamConfig (lattice shapes, gates, edge weights).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.ops.beams import extract_beams
from micro_quad_slam_tpu.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_scan_to_grid,
    make_rays,
    recenter_apply,
    recenter_decide,
    shift_origin,
)
from micro_quad_slam_tpu.ops.scanmatch import match_scan, match_window
from micro_quad_slam_tpu.slam.posegraph import (
    add_edges,
    chain_odometry_graph,
    gauss_newton,
    se2_compose,
    se2_relative,
)
from micro_quad_slam_tpu.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32


def _ekf_track(frames, cfg):
    """Batched EKF odometry: [B, T] frames -> poses f32 [B, T, 3]
    (x, y from the full-pose fusion filter, theta from the logged
    attitude).  Delegates to the fusion replay so the seeding policy
    (x0/y0/z0/yaw0 from the first samples, replay/fusion.py:52-63) is
    defined in exactly one place — the SLAM odometry track is the fusion
    track, bit-for-bit (tests/test_slam.py)."""
    from micro_quad_slam_tpu.replay.fusion import _ekf_replay_batched

    _, track = _ekf_replay_batched(frames, cfg)
    yaw = jnp.deg2rad(frames["yaw_deg"])
    return jnp.stack([track["x"], track["y"], yaw], axis=-1)


def _odo_and_schedule(frames, cfg, origin0=None):
    """EKF odometry + origin/recenter schedule in ONE scan (the fusion
    replay's scan via its extra hook): outputs identical to
    _ekf_track + _origin_schedule — asserted in tests — at one T-length
    loop instead of two (each sequential loop adds per-step overhead)."""
    from micro_quad_slam_tpu.replay.fusion import _ekf_replay_batched

    B, T = frames["x_m"].shape
    yaw = jnp.deg2rad(frames["yaw_deg"])
    if not cfg.slam.recenter:
        odo = _ekf_track(frames, cfg)
        return odo, _origin_schedule(odo, cfg, origin0)

    res = _F32(cfg.map.res_m)
    if origin0 is None:
        nanb = jnp.full((B,), jnp.nan, jnp.float32)
        xc0 = (nanb, nanb)
    else:
        xc0 = (origin0[0], origin0[1])

    def sched_step(carry, mean, _f):
        ox, oy = carry
        x, y = mean[..., 0], mean[..., 1]
        # first step adopts the first posterior as the origin, exactly
        # like _origin_schedule's odo[:, 0] init
        ox = jnp.where(jnp.isnan(ox), x, ox)
        oy = jnp.where(jnp.isnan(oy), y, oy)
        ok = jnp.isfinite(x) & jnp.isfinite(y)
        sx, sy, do = recenter_decide(ox, oy, x, y, ok, cfg.map)
        ox = shift_origin(ox, sx, res)
        oy = shift_origin(oy, sy, res)
        return (ox, oy), {"ox": ox, "oy": oy, "do": do.astype(jnp.int32),
                          "rsy": sy, "rsx": sx}

    _, track = _ekf_replay_batched(frames, cfg, extra=(xc0, sched_step))
    odo = jnp.stack([track["x"], track["y"], yaw], axis=-1)
    sched = {k: track[k] for k in ("ox", "oy", "do", "rsy", "rsx")}
    return odo, sched


def _origin_schedule(odo, cfg, origin0=None):
    """Grid-free recenter schedule from the odometry track: the same
    decide/shift sequence the mapping replay runs (recenter_decide +
    shift_origin, uav_local_nav.c:324-343), so SLAM and the golden
    replay recenter at the same frames for the same pose track.
    odo [B, T, 3] -> dict of [B, T]: ox, oy (origin AFTER frame t's
    recenter), do, rsy, rsx."""
    B, T = odo.shape[:2]
    if origin0 is None:
        ox0, oy0 = odo[:, 0, 0], odo[:, 0, 1]
    else:
        ox0, oy0 = origin0
    if not cfg.slam.recenter:
        z = jnp.zeros((B, T), jnp.int32)
        return {"ox": jnp.broadcast_to(ox0[:, None], (B, T)),
                "oy": jnp.broadcast_to(oy0[:, None], (B, T)),
                "do": z, "rsy": z, "rsx": z}
    res = _F32(cfg.map.res_m)

    def step(carry, xy):
        ox, oy = carry
        x, y = xy
        ok = jnp.isfinite(x) & jnp.isfinite(y)
        sx, sy, do = recenter_decide(ox, oy, x, y, ok, cfg.map)
        ox = shift_origin(ox, sx, res)
        oy = shift_origin(oy, sy, res)
        return (ox, oy), {"ox": ox, "oy": oy,
                          "do": do.astype(jnp.int32), "rsy": sy, "rsx": sx}

    _, out = lax.scan(step, (ox0, oy0),
                      (jnp.moveaxis(odo[..., 0], 0, 1),
                       jnp.moveaxis(odo[..., 1], 0, 1)), unroll=8)
    return {k: jnp.moveaxis(v, 0, 1) for k, v in out.items()}


def _recenter_grids(grids, do, rsy, rsx, cfg, geom):
    """Apply per-flight recenters to a [B] grid batch behind a
    batch-level cond (recentering is rare and touches the full grid)."""
    def apply(g):
        return jax.vmap(
            lambda gi, sxi, syi, di: jnp.where(
                di != 0, recenter_apply(gi, sxi, syi, cfg.map, geom), gi)
        )(g, rsx, rsy, do)

    return lax.cond(jnp.any(do != 0), apply, lambda g: g, grids)


def _match_kf(grids, beams_kf, x, y, yaw_deg, ox, oy, cfg, geom):
    """Scan-match one keyframe per flight against the current grid;
    accept the correction when quality clears the config gate."""
    s = cfg.slam
    res = jax.vmap(
        lambda g, bb, xi, yi, yi2, oxi, oyi: match_scan(
            g, bb, xi, yi, yi2, oxi, oyi, cfg.map, cfg.tof, geom,
            s.match_n_xy, s.match_n_yaw, s.match_xy_step_m,
            s.match_yaw_step_deg)
    )(grids, beams_kf, x, y, yaw_deg, ox, oy)
    ok = res.quality > _F32(s.match_min_quality)
    return (jnp.where(ok, res.x, x), jnp.where(ok, res.y, y),
            jnp.where(ok, res.yaw_deg, yaw_deg))


def _map_pass(beams, poses, cfg, geom, match: bool, kf_mask_t, sched=None,
              grid0=None, snap_mask_t=None, update_mask_t=None):
    """One sequential mapping pass.  poses [B, T, 3] (theta in rad).
    If match=True, keyframe ticks scan-match the pose against the map
    SNAPSHOT (refreshed at snap_mask_t frames — the submap-lag
    formulation, SlamConfig.match_chunk_intervals; None = every
    keyframe) before updating, and the corrected poses are recorded.
    sched: origin/recenter schedule from _origin_schedule (None = fixed
    origin at the track start, no recentering).  grid0 continues a
    previous segment's map (mqs slam --resume).  update_mask_t [T] bool:
    frames whose scan lands on the grid (None = all; SLAM pass 1 passes
    the keyframe mask when SlamConfig.match_map_kf_only) — recenters
    still roll the grid on EVERY frame regardless."""
    B, T = poses.shape[:2]
    if grid0 is None:
        grid0 = jnp.zeros((B, geom.prows, geom.pcols), jnp.int8)
    if sched is None:
        z = jnp.zeros((B, T), jnp.int32)
        sched = {"ox": jnp.broadcast_to(poses[:, 0, 0][:, None], (B, T)),
                 "oy": jnp.broadcast_to(poses[:, 0, 1][:, None], (B, T)),
                 "do": z, "rsy": z, "rsx": z}
    if snap_mask_t is None:
        snap_mask_t = kf_mask_t

    def step(carry, inp):
        grid, snap, sox, soy = carry
        b, pose, kf_due = inp["beams"], inp["pose"], inp["kf"]
        ox, oy = inp["ox"], inp["oy"]
        grid = _recenter_grids(grid, inp["do"], inp["rsy"], inp["rsx"],
                               cfg, geom)
        # refresh the match snapshot AFTER this frame's recenter, BEFORE
        # this frame's update — exactly the chunk-start state of the
        # chunked path (mid-interval recenters do NOT roll the snapshot).
        # The snapshot's ORIGIN is captured with it: keyframes after a
        # mid-interval recenter must look cells up in the frame the
        # snapshot grid was rolled to, not their own shifted origin.
        snap, sox, soy = lax.cond(
            inp["snap"], lambda _: (grid, ox, oy),
            lambda s: s, (snap, sox, soy))
        x, yw = pose[..., 0], pose[..., 2]
        y = pose[..., 1]
        yaw_deg = jnp.rad2deg(yw)

        if match:
            x, y, yaw_deg = lax.cond(
                kf_due,
                lambda a: _match_kf(a[0], b, a[1], a[2], a[3], sox, soy,
                                    cfg, geom),
                lambda a: (a[1], a[2], a[3]),
                (snap, x, y, yaw_deg))

        def upd(g):
            return jax.vmap(
                lambda gi, bb, xi, yi, yawi, oxi, oyi: apply_scan_to_grid(
                    gi, bb, xi, yi, yawi, oxi, oyi, True, cfg.map,
                    cfg.tof, geom)
            )(g, b, x, y, yaw_deg, ox, oy)

        if update_mask_t is None:
            grid = upd(grid)
        else:
            grid = lax.cond(inp["upd"], upd, lambda g: g, grid)
        out = jnp.stack([x, y, jnp.deg2rad(yaw_deg)], axis=-1)
        return (grid, snap, sox, soy), out

    seq = {
        "beams": jnp.moveaxis(beams, 0, 1),
        "pose": jnp.moveaxis(poses, 0, 1),
        "kf": kf_mask_t,
        "snap": snap_mask_t,
        "ox": jnp.moveaxis(sched["ox"], 0, 1),
        "oy": jnp.moveaxis(sched["oy"], 0, 1),
        "do": jnp.moveaxis(sched["do"], 0, 1),
        "rsy": jnp.moveaxis(sched["rsy"], 0, 1),
        "rsx": jnp.moveaxis(sched["rsx"], 0, 1),
    }
    if update_mask_t is not None:
        seq["upd"] = update_mask_t
    (grid, _, _, _), corrected = lax.scan(
        step, (grid0, grid0, sched["ox"][:, 0], sched["oy"][:, 0]), seq)
    return grid, jnp.moveaxis(corrected, 0, 1)


def _compose_kf_sched(sch, B: int, nc: int, kf_every: int, n_kf: int):
    """Compose the per-frame recenter schedule over keyframe intervals:
    slot j's composed window covers frames (T_{j-1}, T_j] so rolling once
    per keyframe slot reaches the same grid as rolling every frame.
    Zero-fill translations compose exactly — roll(roll(G, s1), s2) ==
    roll(G, s1+s2) — for same-sign shift pairs (the divergence-driven
    multi-recenter case); an OPPOSITE-sign pair inside one kf_every
    interval could differ near the grid edge, but needs two ~12.5 m pose
    jumps in opposite directions within <1 s — unreachable from
    recenter_decide's 15 m threshold under finite poses (NaN jumps are
    isfinite-gated).  Composed shifts stay < prows: even back-to-back
    125-cell clamped shifts sum to 250 << 608.  Returns (comp, tail):
    comp[k] [B, K_p] per-slot composed shifts/flags, tail[k] [B] the
    post-last-keyframe remainder (rolled once after the scan)."""
    K_p = nc * n_kf
    seg = lambda a: jnp.pad(
        a[:, 1:], ((0, 0), (0, 1))).reshape(B, K_p, kf_every).sum(-1)
    comp = {}
    tail = {}
    for k in ("rsy", "rsx", "do"):
        s = seg(sch[k])
        comp[k] = jnp.concatenate([sch[k][:, :1], s[:, :-1]], axis=1)
        tail[k] = s[:, -1]                                # after last kf
    comp["do"] = (comp["do"] != 0).astype(jnp.int32)
    tail["do"] = (tail["do"] != 0).astype(jnp.int32)
    return comp, tail


def _pad_chunk_inputs(beams, poses, sched, B: int, T: int, C: int,
                      nc: int):
    """Pad [B, T] chunk-pass inputs to nc*C frames with inert frames:
    NaN beams make every ray invalid (grid untouched); padded poses are
    sliced off the output; padded origins reuse the last frame so
    make_rays stays finite."""
    padn = nc * C - T
    pad_t = lambda a, v: jnp.pad(a, ((0, 0), (0, padn)) + ((0, 0),) *
                                 (a.ndim - 2), constant_values=v)
    beams_p = pad_t(beams, np.nan)
    poses_p = pad_t(poses, 0.0)
    sch = {k: pad_t(v, 0) for k, v in sched.items()}
    sch["ox"] = pad_t(sched["ox"], 0.0)
    sch["oy"] = pad_t(sched["oy"], 0.0)
    if padn:
        sch["ox"] = sch["ox"].at[:, T:].set(sched["ox"][:, -1:])
        sch["oy"] = sch["oy"].at[:, T:].set(sched["oy"][:, -1:])
    return beams_p, poses_p, sch


def _map_pass_nofb(beams, poses, cfg, geom, kf_every: int, sched,
                   grid0=None, n_iters: int | None = None):
    """Feedback-free pass 1 (SlamConfig.match_feedback=False): within an
    iteration the match map accumulates keyframe scans at FIXED pose
    estimates (iteration 1: raw odometry; iteration i>1: the previous
    iteration's matched poses), so the grid chain never depends on the
    matcher inside the iteration.  The snapshot grids at each match
    interval start are produced by a match-free chunk scan, and ALL
    keyframe matches then run as ONE flat batch against their
    interval-start snapshot.  This removes the match->update->match
    serialization of the feedback formulation.
    SlamConfig.match_iters repetitions of (rebuild map at current
    estimates -> flat re-match) recover the accuracy the feedback
    formulation got from correcting the map as it grew — the iteration
    approximates that fixed point while staying fully parallel within
    each round (fig-8 A/B in tests/test_slam.py).  Matching semantics
    per keyframe (snapshot state, snapshot origin, lattice, quality
    gate) are identical to the feedback path.
    Requires match_map_kf_only (caller asserts).
    Returns (final grids, matched poses [B, T, 3])."""
    B, T = poses.shape[:2]
    grids0 = (jnp.zeros((B, geom.prows, geom.pcols), jnp.int8)
              if grid0 is None else grid0)
    n_iv = max(int(cfg.slam.match_chunk_intervals), 1)
    C = kf_every * n_iv
    nc = -(-T // C)
    # schedule/beams padding is pose-independent; poses re-pad per
    # iteration (the estimates move, the recenter schedule does not —
    # origins follow the raw odometry exactly as the reference's grid
    # origin follows its dead-reckoned pose)
    beams_p, _, sch = _pad_chunk_inputs(beams, poses, sched, B, T, C, nc)
    kf_offs = np.arange(0, C, kf_every)
    n_kf = len(kf_offs)
    K_p = nc * n_kf
    comp, tail = _compose_kf_sched(sch, B, nc, kf_every, n_kf)

    ksel = lambda a: a[:, ::kf_every]                     # [B, K_p, ...]
    chunked_k = lambda a: jnp.moveaxis(
        a.reshape((B, nc, n_kf) + a.shape[2:]), 0, 1)     # [nc, B, n_kf]
    kf_beams = ksel(beams_p)                              # [B, K_p, 4, 8]
    kf_ox, kf_oy = ksel(sch["ox"]), ksel(sch["oy"])       # [B, K_p]

    seq_fix = {
        "beams": chunked_k(kf_beams),
        "ox": chunked_k(kf_ox),
        "oy": chunked_k(kf_oy),
        **{k: chunked_k(comp[k]) for k in ("do", "rsy", "rsx")},
    }

    def body(grids, inp):
        # chunk-start recenter outside the update (the snapshot the
        # matches see is the ROLLED grid), then zero its do flag
        grids = _recenter_grids(grids, inp["do"][:, 0], inp["rsy"][:, 0],
                                inp["rsx"][:, 0], cfg, geom)
        snap = grids
        do = inp["do"].at[:, 0].set(0)
        x, y = inp["pose"][..., 0], inp["pose"][..., 1]
        yaw_deg = jnp.rad2deg(inp["pose"][..., 2])
        for sl in range(n_kf):
            if sl:   # slot-0 recenter already applied above
                grids = _recenter_grids(grids, do[:, sl],
                                        inp["rsy"][:, sl],
                                        inp["rsx"][:, sl], cfg, geom)
            grids = jax.vmap(
                lambda gi, bb, xi, yi, yawi, oxi, oyi:
                apply_scan_to_grid(gi, bb, xi, yi, yawi, oxi, oyi,
                                   True, cfg.map, cfg.tof, geom)
            )(grids, inp["beams"][:, sl], x[:, sl], y[:, sl],
              yaw_deg[:, sl], inp["ox"][:, sl], inp["oy"][:, sl])
        return grids, (snap, inp["ox"][:, 0], inp["oy"][:, 0])

    # ALL keyframe matches in one flat (vmapped over interval x slot)
    # batch against the interval-start snapshots — nothing downstream of
    # a match feeds a grid, so the whole batch runs in parallel.  Every
    # slot looks cells up with the chunk-start origin: after a mid-chunk
    # recenter a keyframe's own origin no longer describes the snapshot's
    # frame.
    def match_chunk(snap_c, beams_c, pose_c, sox_c, soy_c):
        return jax.vmap(
            lambda bm, xk, yk, wk: _match_kf(snap_c, bm, xk, yk, wk,
                                             sox_c, soy_c, cfg, geom),
            in_axes=(1, 1, 1, 1), out_axes=1,
        )(beams_c, pose_c[..., 0], pose_c[..., 1],
          jnp.rad2deg(pose_c[..., 2]))

    tb = lambda a: jnp.moveaxis(a, 0, 1).reshape(B, K_p)

    def one_round(est_p):
        """(map chunk scan at `est` -> flat match batch)."""
        seq = dict(seq_fix, pose=chunked_k(ksel(est_p)))
        grids, (snaps, sox_c, soy_c) = lax.scan(body, grids0, seq)
        grids = _recenter_grids(grids, tail["do"], tail["rsy"],
                                tail["rsx"], cfg, geom)
        mx, my, myaw = jax.vmap(match_chunk)(
            snaps, seq_fix["beams"], seq["pose"], sox_c, soy_c)
        return grids, tb(mx), tb(my), tb(myaw)            # [B, K_p]

    matched = poses
    if n_iters is None:
        n_iters = int(cfg.slam.match_iters)
    for _ in range(max(n_iters, 1)):
        _, poses_p, _ = _pad_chunk_inputs(beams, matched, sched, B, T, C,
                                          nc)
        grids, mx, my, myaw = one_round(poses_p)
        # place the corrections at the keyframe slots through a static
        # reshape (slot stride is kf_every in the padded domain) — basic
        # indexing only, no scatter
        mr = poses_p.reshape(B, K_p, kf_every, 3)
        mr = mr.at[:, :, 0, 0].set(mx)
        mr = mr.at[:, :, 0, 1].set(my)
        mr = mr.at[:, :, 0, 2].set(jnp.deg2rad(myaw))
        matched = mr.reshape(B, nc * C, 3)[:, :T]
    return grids, matched


def _loop_stage(kfp, kf_beams, kf_ox, kf_oy, cfg, geom):
    """Pass 1b: proximity-gated keyframe-to-keyframe revisit loop edges
    (a star to node 0 alone only weakly corrects genuine revisit/figure-8
    drift).  For each keyframe j, the n_cand nearest keyframes at least
    `loop_min_gap` keyframes older within `loop_r_max_m` are matched against local maps rasterized from each
    candidate's scan alone, and the loop_edges best by match quality
    become graph edges with measured relative transforms.

    kfp [B, K, 3] keyframe pose estimates; kf_beams [B, K, 4, 8];
    kf_ox/kf_oy [B, K] per-keyframe grid origins.  Returns per flight
    (edge ij [B, E, 2], z [B, E, 3], ok [B, E], quality [B, E]) with
    E = loop_edges * K."""
    K = kfp.shape[1]
    s = cfg.slam
    iidx = jnp.arange(K)
    n_edges = max(int(s.loop_edges), 1)
    n_cand = max(int(s.loop_cand), n_edges)

    # stage A: raster every keyframe's scan into its own [96, 128]
    # LOCAL window, once.  The field is ENDPOINT-ONLY (the classic
    # correlative-matching occupancy likelihood field): the matcher
    # scores endpoint log-odds, so occupied evidence is what
    # localizes, and the free-space carve of the full 32-ray raster is
    # skipped — the field is one exact one-hot matmul pair per keyframe.
    # Kept as a separate vmapped stage from the matching: fusing
    # raster+match in one vmapped body compiled to a slower program.
    def _raster_windows(kf_pose, kf_beams_b, ox_k, oy_k):
        def raster(k):
            pk = kf_pose[k]
            rays = make_rays(kf_beams_b[k], pk[0], pk[1],
                             jnp.rad2deg(pk[2]), ox_k[k], oy_k[k], True,
                             cfg.map, cfg.tof)
            ey = rays["ey"] + geom.win_r    # endpoint cells, window coords
            ex = rays["ex"] + geom.win_r
            d = jnp.where(rays["valid"], rays["end_delta"],
                          0).astype(jnp.float32)
            rows = (jnp.arange(geom.win_rows)[:, None]
                    == ey[None, :]).astype(jnp.float32)     # [96, 32]
            cols = (ex[:, None]
                    == jnp.arange(geom.win_cols)[None, :]).astype(
                        jnp.float32)                        # [32, 128]
            # HIGHEST: exact f32 sums of small integers, not TF32
            win = lax.dot_general(rows * d[None, :], cols,
                                  (((1,), (0,)), ((), ())),
                                  precision=lax.Precision.HIGHEST)
            win = jnp.clip(win, 0, cfg.map.lo_max)
            # int8 carry between the stages: clipped integer log-odds
            # are int8-exact, and the [B, K, 96, 128] field batch drops
            # from 163 MB to 41 MB of HBM traffic at B=128, K=26
            return (win.astype(jnp.int8),
                    rays["pcy"] + geom.pad - geom.win_r,
                    rays["pcx"] + geom.pad - geom.win_r)

        return jax.vmap(raster)(jnp.arange(K))

    # candidate selection is pure proximity logic — it never depends on
    # a match result, so the n_cand nearest-older candidate indices per
    # keyframe are precomputed up front
    def _cand_indices(kf_pose):
        pos = kf_pose[:, :2]
        d2 = jnp.sum((pos[None, :, :] - pos[:, None, :]) ** 2, -1)  # [i, j]
        gap_ok = (iidx[None, :] - iidx[:, None]) >= s.loop_min_gap
        cand = jnp.where(gap_ok, d2, jnp.inf)

        def cand_round(cand, _):
            i_best = jnp.argmin(cand, axis=0)               # [K] per j
            near = cand[i_best, iidx] < _F32(s.loop_r_max_m) ** 2
            cand = jnp.where(jnp.arange(K)[:, None] == i_best[None, :],
                             jnp.inf, cand)
            return cand, (i_best.astype(jnp.int32), near)

        _, (ic, near) = lax.scan(cand_round, cand, None, length=n_cand)
        return ic, near                    # [n_cand, K], [n_cand, K] bool

    # SlamConfig.loop_cand nearest older candidates per keyframe are
    # all MATCHED; the loop_edges best BY MATCH QUALITY become edges
    # (round 4: proximity picks the candidate to try, quality picks
    # the edges to trust — a near-but-featureless revisit no longer
    # crowds out a sharper slightly-farther one)
    def _select_edges(ic, zc, qc):
        # ic [n_cand, K]; zc [n_cand, K, 3]; qc [n_cand, K] (-inf = gated)
        ijs, zs, oks, qs = [], [], [], []
        carange = jnp.arange(n_cand)[:, None]
        for _ in range(n_edges):
            sel = jnp.argmax(qc, axis=0)                    # [K] per j
            pick = (carange == sel[None, :])                # [n_cand, K]
            ijs.append(jnp.stack(
                [jnp.where(pick, ic, 0).sum(0), iidx.astype(jnp.int32)],
                axis=-1))
            zs.append(jnp.where(pick[..., None], zc, 0.0).sum(0))
            qbest = jnp.where(pick, qc, -jnp.inf).max(0)
            oks.append(jnp.isfinite(qbest))
            qs.append(jnp.where(jnp.isfinite(qbest), qbest, 0.0))
            qc = jnp.where(pick, -jnp.inf, qc)
        return (jnp.concatenate(ijs), jnp.concatenate(zs),
                jnp.concatenate(oks), jnp.concatenate(qs))

    def loop_edges(kf_pose, kf_beams_b, ox_k, oy_k):
        wins, wy0s, wx0s = _raster_windows(kf_pose, kf_beams_b, ox_k,
                                           oy_k)
        ic, near = _cand_indices(kf_pose)

        # stage B: match each keyframe j against its revisit candidate's
        # local map — both sides in keyframe i's origin frame so the
        # window coordinates line up even across recenters; the relative
        # transform z is world-frame and origin-independent.  Pruned
        # lattice: the guess is already odometry-good.
        def measure(i, j, ok):
            pi, pj = kf_pose[i], kf_pose[j]
            res = match_window(wins[i], wy0s[i], wx0s[i], kf_beams_b[j],
                               pj[0], pj[1], jnp.rad2deg(pj[2]), ox_k[i],
                               oy_k[i], cfg.map, cfg.tof, geom,
                               s.loop_n_xy, s.loop_n_yaw,
                               s.match_xy_step_m, s.match_yaw_step_deg)
            pj_corr = jnp.stack([res.x, res.y,
                                 jnp.deg2rad(res.yaw_deg)])
            z = se2_relative(pi, pj_corr)
            return (z, ok & (res.quality > _F32(s.loop_min_quality)),
                    res.quality)

        def meas_round(_, inp):
            # lax.scan (not a python loop): the matcher graph is large
            # and n_cand unrolled copies ballooned CPU compile time
            i_r, near_r = inp
            z, ok, q = jax.vmap(measure)(i_r, iidx, near_r)
            return 0, (z, jnp.where(ok, q, -jnp.inf))

        _, (zc, qc) = lax.scan(meas_round, 0, (ic, near))
        return _select_edges(ic, zc, qc)

    return jax.vmap(loop_edges)(kfp, kf_beams, kf_ox, kf_oy)


class SlamResult(NamedTuple):
    grid: jnp.ndarray            # drift-corrected map [B, prows, pcols]
    track: jnp.ndarray           # corrected poses [B, T, 3] (rad)
    odo_track: jnp.ndarray       # raw EKF odometry [B, T, 3]
    kf_idx: jnp.ndarray          # keyframe frame indices [K]
    kf_nodes: jnp.ndarray        # optimized keyframe poses [B, K, 3]
    gn_costs: jnp.ndarray        # GN cost per iteration [B, iters]
    origin: tuple                # final (origin_x [B], origin_y [B])


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def slam_replay(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                geom: GridGeom = DEFAULT_GEOM, kf_every: int | None = None,
                gn_iters: int | None = None, state0=None) -> SlamResult:
    """frames: dict of [B, T] scanlog arrays (scanlog_to_arrays +
    fusion_arrays union).  Returns the drift-corrected map and track.
    kf_every / gn_iters override cfg.slam when given.
    state0: a previous segment's (grid [B, prows, pcols], origin_x [B],
    origin_y [B]) — its map and origins seed both the matching pass and
    the re-raster, so a flight split across logs continues in the same
    frame (mqs slam --save-state / --resume)."""
    return _slam_impl(frames, cfg, geom, kf_every, gn_iters, state0)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 6))
def _slam_impl(frames: dict, cfg: PipelineConfig, geom: GridGeom,
               kf_every: int | None, gn_iters: int | None, state0=None,
               upto: int = 99):
    """slam_replay body.  upto truncates the pipeline after a stage
    (0=odo/sched, 1=pass 1, 2=loop edges, 3=pose graph, 4=track) so the
    per-stage cost is measurable by differencing."""
    kf_every = cfg.slam.kf_every if kf_every is None else kf_every
    gn_iters = cfg.slam.gn_iters if gn_iters is None else gn_iters
    B, T = frames["x_m"].shape
    beams, _ = extract_beams(frames["grid_mm"], cfg.tof)

    # keyframe cadence shared across the batch (single source of truth
    # for both the sequential mask and the chunk boundaries); snapshots
    # refresh every match_chunk_intervals keyframe intervals
    kf_mask = (jnp.arange(T) % kf_every) == 0
    n_iv = max(int(cfg.slam.match_chunk_intervals), 1)
    snap_mask = (jnp.arange(T) % (kf_every * n_iv)) == 0
    kf_idx = jnp.arange(0, T, kf_every)
    K = kf_idx.shape[0]

    grid0 = origin0 = None
    if state0 is not None:
        grid0 = jnp.asarray(state0[0])
        origin0 = (jnp.asarray(state0[1]), jnp.asarray(state0[2]))

    # pass 0: EKF odometry + the origin/recenter schedule, fused into
    # one scan.  The schedule is decided grid-free from the odometry
    # track (matched corrections are bounded by the lattice radius, so
    # the decide threshold sees essentially the same pose).
    odo, sched = _odo_and_schedule(frames, cfg, origin0)
    if upto == 0:
        return odo, sched

    def pass1(est, n_iters=None):
        """Pass 1 at pose estimates `est`: scan-matched mapping.  Default
        (feedback-free keyframe match map): a match-free chunk scan
        builds the snapshot grids, then every keyframe matches in one
        flat batch (_map_pass_nofb).  The feedback formulation (match
        corrections land on the match map) runs the sequential scan.
        n_iters: per-round match iteration override
        (SlamConfig.match_iters_later)."""
        if cfg.slam.match_map_kf_only and not cfg.slam.match_feedback:
            _, matched = _map_pass_nofb(beams, est, cfg, geom, kf_every,
                                        sched, grid0=grid0,
                                        n_iters=n_iters)
        else:
            _, matched = _map_pass(
                beams, est, cfg, geom, True, kf_mask, sched, grid0=grid0,
                snap_mask_t=snap_mask,
                update_mask_t=(kf_mask if cfg.slam.match_map_kf_only
                               else None))
        return matched

    # pass 1b: REAL loop closure — proximity-gated keyframe-to-keyframe
    # revisit matches (a star to node 0 alone only weakly corrects
    # genuine revisit/figure-8 drift).  For each
    # keyframe j, the nearest keyframe i at least `loop_min_gap`
    # keyframes older within `loop_r_max_m` becomes a loop candidate;
    # keyframe j's scan is then matched against a fresh local map
    # rasterized from keyframe i's scan alone, giving a measured
    # relative transform.
    s = cfg.slam
    kf_beams = beams[:, kf_idx]                         # [B, K, 4, 8]
    kf_ox = sched["ox"][:, kf_idx]                      # [B, K]
    kf_oy = sched["oy"][:, kf_idx]

    run_loop = lambda kfp: _loop_stage(kfp, kf_beams, kf_ox, kf_oy, cfg,
                                       geom)

    # pass 2: pose graph = odometry edges + match anchors + loop edges.
    # Loop edges enter with quality-scaled information and a Huber
    # robust loss (IRLS in gauss_newton) so a bad edge that clears the
    # accept gate degrades gracefully instead of being fully trusted.
    def build_and_solve(odo_b, matched_b, lij, lz, lok, lq, sc_b,
                        nodes0=None, iters=None):
        g = chain_odometry_graph(odo_b, kf_idx, s.odo_w)
        # per-flight odometry scale (SlamConfig.odo_scale_*): the fitted
        # flow-gain correction rescales the odometry edge translations
        g = g._replace(edges_z=g.edges_z * jnp.stack(
            [sc_b, sc_b, jnp.float32(1.0)]))
        anchors = se2_relative(matched_b[kf_idx][0][None].repeat(K - 1, 0),
                               matched_b[kf_idx][1:])
        ij = jnp.stack([jnp.zeros(K - 1, jnp.int32),
                        jnp.arange(1, K, dtype=jnp.int32)], axis=-1)
        g = add_edges(g, ij, anchors, s.anchor_w)
        qsc = jnp.clip(lq / _F32(s.loop_q_ref), _F32(s.loop_q_min),
                       _F32(s.loop_q_max))
        g = add_edges(g, lij, lz,
                      jnp.asarray(s.loop_w, jnp.float32)[None] *
                      qsc[:, None],
                      mask=lok, huber=s.loop_huber)
        if nodes0 is not None:
            # warm start (refine rounds): the previous solution is a far
            # better initial guess than composed odometry, so the solve
            # converges in gn_refine_iters < gn_iters steps.  Node 0
            # stays pinned by gauss_newton's gauge handling.
            g = g._replace(nodes=nodes0)
        else:
            g = g._replace(nodes=g.nodes.at[0].set(matched_b[kf_idx][0]))
        g, costs = gauss_newton(g, iters=gn_iters if iters is None
                                else iters)
        return g.nodes, costs


    # OUTER global rounds (SlamConfig.slam_outer): pass 1's match map is
    # distorted by the very drift it corrects; rebuilding it at the
    # loop-consistent SOLVED track removes the distortion, so round-2
    # matches pin mid-track absolute drift the loop edges alone cannot
    # reach.  upto truncations apply within the LAST round (earlier
    # rounds must complete to produce the estimate the final round
    # consumes).
    owner = jnp.clip(jnp.arange(T) // kf_every, 0, K - 1)
    rel = se2_relative(odo[:, kf_idx][:, owner], odo)       # [B, T, 3]
    odo_kf_d = jnp.linalg.norm(jnp.diff(odo[:, kf_idx, :2], axis=1),
                               axis=-1)                     # [B, K-1]
    est = odo
    sc = jnp.ones((B,), jnp.float32)
    n_outer = max(int(s.slam_outer), 1)
    it_later = (int(s.match_iters_later)
                if int(s.match_iters_later) > 0 else None)
    gn_ref = (int(s.gn_refine_iters)
              if int(s.gn_refine_iters) > 0 else None)
    for rnd in range(n_outer):
        last = rnd == n_outer - 1
        matched = pass1(est, n_iters=None if rnd == 0 else it_later)
        if last and upto == 1:
            return matched
        loop_ij, loop_z, loop_ok, loop_q = run_loop(matched[:, kf_idx])
        if last and upto == 2:
            return matched, loop_ij, loop_z, loop_ok

        solve = lambda lij, lz, lok, lq, n0=None, it=None, m=matched, \
            c=sc: jax.vmap(
                lambda *a: build_and_solve(*a, iters=it)
            )(odo, m, lij, lz, lok, lq, c,
              *(() if n0 is None else (n0,)))
        kf_nodes, gn_costs = solve(loop_ij, loop_z, loop_ok, loop_q)
        # refine rounds: the solved keyframe poses are better guesses
        # (and better raster poses) than pass 1's — re-run the loop
        # stage at the solved nodes and re-solve.  Matches that failed
        # or mis-peaked at drift-distorted guesses land on the second
        # try.  lax.scan: one compiled copy of the (large) loop-stage
        # graph regardless of rounds.  Non-final rounds run
        # loop_refine_early rounds (their solve only seeds the next
        # round's map rebuild); refine solves warm-start from the
        # previous nodes with gn_refine_iters iterations.
        n_ref = max(int(s.loop_refine if last else (
            s.loop_refine_early if int(s.loop_refine_early) >= 0
            else s.loop_refine)), 0)
        if n_ref:
            def refine(carry, _):
                kf_nodes, costs_prev = carry
                lij, lz, lok, lq = run_loop(kf_nodes)
                # warm start is tied to the explicit gn_refine_iters
                # opt-in: with it unset the refine solve cold-starts
                # from composed odometry exactly like round 4
                nodes, costs = solve(
                    lij, lz, lok, lq,
                    n0=None if gn_ref is None else kf_nodes, it=gn_ref)
                # keep SlamResult.gn_costs describing the SAME solve
                # that produced the returned nodes: shorter warm solves
                # pad their cost trace to the cold solve's width with NaN
                if costs.shape[1] < costs_prev.shape[1]:
                    costs = jnp.pad(
                        costs,
                        ((0, 0), (0, costs_prev.shape[1] - costs.shape[1])),
                        constant_values=jnp.nan)
                return (nodes, costs), None
            (kf_nodes, gn_costs), _ = lax.scan(
                refine, (kf_nodes, gn_costs), None, length=n_ref)
        if last and upto == 3:
            return kf_nodes, gn_costs

        # re-fit the per-flight odometry scale from the solved keyframe
        # step lengths (LS through the origin over |step| pairs,
        # rotation-invariant), for this round's composition and the next
        # round's odometry edges
        sol_kf_d = jnp.linalg.norm(jnp.diff(kf_nodes[..., :2], axis=1),
                                   axis=-1)                 # [B, K-1]
        sc = jnp.clip(
            jnp.sum(odo_kf_d * sol_kf_d, axis=1)
            / jnp.maximum(jnp.sum(odo_kf_d * odo_kf_d, axis=1), 1e-9),
            _F32(s.odo_scale_min), _F32(s.odo_scale_max))

        # correct all frames rigidly relative to their owning keyframe
        # (intra-interval translations carry the fitted scale)
        rel_sc = rel * jnp.stack(
            [sc, sc, jnp.ones_like(sc)], axis=-1)[:, None, :]
        track = se2_compose(kf_nodes[:, owner], rel_sc)
        est = track
    if upto == 4:
        return track

    # pass 3: re-raster from the corrected track (no map feedback)
    grid, _ = _map_pass(beams, track, cfg, geom, False, kf_mask, sched,
                        grid0=grid0)
    origin = (sched["ox"][:, -1], sched["oy"][:, -1])
    return SlamResult(grid, track, odo, kf_idx, kf_nodes, gn_costs, origin)
