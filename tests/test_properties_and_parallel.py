"""Property tests (SURVEY.md §4 item 3) and mesh-sharding equality
(item 5): grid bounds, Bresenham symmetry, recenter content preservation,
and sharded-vs-unsharded replay equality on the virtual 8-device mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from micro_quad_slam_tpu.golden.model import GoldenMapper
from micro_quad_slam_tpu.ops import logical_grid
from micro_quad_slam_tpu.parallel import make_mesh, replay_mapping_sharded
from micro_quad_slam_tpu.replay import replay_mapping_batched, scanlog_to_arrays
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import CL_PROFILE, UL_PROFILE


# ------------------------------ properties --------------------------------

def test_grid_always_bounded():
    rng = np.random.default_rng(0)
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    for _ in range(200):
        beams = rng.uniform(0.06, 4.0, (4, 8)).astype(np.float32)
        m.map_update_from_beams(beams, rng.uniform(-1, 1),
                                rng.uniform(-1, 1), rng.uniform(-180, 180))
    assert m.grid.max() <= 80 and m.grid.min() >= -80


def test_bresenham_reversal_symmetry():
    """A ray A->B and a ray B->A visit the same FREE cell set minus the
    endpoint handling: both walks cover the same line cells (Bresenham with
    the err=dx+dy variant is direction-symmetric on the visited set)."""
    m1 = GoldenMapper()
    m1.init_map(0.0, 0.0)
    m2 = GoldenMapper()
    m2.init_map(0.0, 0.0)
    a, b = (0.33, -0.21), (2.87, 1.44)
    m1.raycast_update(*a, *b, False)   # miss endpoint: pure -1 trail
    m2.raycast_update(*b, *a, False)
    s1 = set(map(tuple, np.argwhere(m1.grid != 0)))
    s2 = set(map(tuple, np.argwhere(m2.grid != 0)))
    # visited cells identical except each walk skips decrementing ITS
    # endpoint cell (miss => unchanged): symmetric difference covers at
    # most the two endpoint cells
    assert len(s1 ^ s2) <= 2


def test_recenter_is_pure_translation_of_interior():
    rng = np.random.default_rng(1)
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    inner = rng.integers(-80, 81, (100, 100)).astype(np.int8)
    m.grid[200:300, 200:300] = inner
    m.recenter_if_needed(16.0, 0.0)  # shift clamped to 125 cells in x
    np.testing.assert_array_equal(m.grid[200:300, 200 - 125:300 - 125], inner)
    # everything outside the translated block is zero
    total = np.abs(m.grid.astype(np.int32)).sum()
    assert total == np.abs(inner.astype(np.int32)).sum()


def test_replay_is_deterministic():
    log = synth_room_scanlog(n_frames=12, seed=2, noise_mm=4.0)
    f = {k: v[None] for k, v in scanlog_to_arrays(log).items()}
    s1, _ = replay_mapping_batched(f, UL_PROFILE)
    s2, _ = replay_mapping_batched(f, UL_PROFILE)
    np.testing.assert_array_equal(np.asarray(s1.grid), np.asarray(s2.grid))


@pytest.mark.slow
def test_cl_profile_gates_differ():
    # flow quality 40: UL (>=50) must skip mapping, CL (>=30) must map
    log = synth_room_scanlog(n_frames=6, seed=3)
    log.of_rate_x[:] = 0.1   # flow "fresh"
    log.of_q[:] = 40
    f = {k: v[None] for k, v in scanlog_to_arrays(log).items()}
    _, outs_ul = replay_mapping_batched(f, UL_PROFILE)
    _, outs_cl = replay_mapping_batched(f, CL_PROFILE)
    assert not np.asarray(outs_ul["used"]).any()
    assert np.asarray(outs_cl["used"]).all()


# ------------------------------ sharding ----------------------------------

@pytest.mark.slow
def test_sharded_replay_matches_unsharded():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    logs = [synth_room_scanlog(n_frames=10, seed=s, path="hover",
                               yaw_rate_dps=12.0 + s, noise_mm=4.0)
            for s in range(8)]
    frames = [scanlog_to_arrays(lg) for lg in logs]
    batched = {k: np.stack([f[k] for f in frames]) for k in frames[0]}

    mesh = make_mesh(8)
    s_state, s_outs, metrics = replay_mapping_sharded(batched, UL_PROFILE, mesh)
    u_state, u_outs = replay_mapping_batched(
        {k: jnp.asarray(v) for k, v in batched.items()}, UL_PROFILE)

    np.testing.assert_array_equal(np.asarray(s_state.grid),
                                  np.asarray(u_state.grid))
    np.testing.assert_array_equal(np.asarray(s_outs["used"]),
                                  np.asarray(u_outs["used"]))
    assert int(metrics["frames_total"]) == 80
    # the result really was sharded over the mesh
    assert len(s_state.grid.sharding.device_set) == 8


def test_sharded_hybrid_matches_unsharded():
    """The hybrid production kernel with the batch sharded over the
    mesh: bit-identical grids and gates to the unsharded hybrid replay."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    logs = [synth_room_scanlog(n_frames=10, seed=40 + s, noise_mm=4.0)
            for s in range(8)]
    frames = [scanlog_to_arrays(lg) for lg in logs]
    batched = {k: np.stack([f[k] for f in frames]) for k in frames[0]}

    mesh = make_mesh(8)
    s_state, s_outs, metrics = replay_mapping_sharded(
        batched, UL_PROFILE, mesh, kernel="hybrid")
    u_state, u_outs = replay_mapping_batched(
        {k: jnp.asarray(v) for k, v in batched.items()}, UL_PROFILE,
        kernel="hybrid")

    np.testing.assert_array_equal(np.asarray(s_state.grid),
                                  np.asarray(u_state.grid))
    np.testing.assert_array_equal(np.asarray(s_outs["used"]),
                                  np.asarray(u_outs["used"]))
    assert len(s_state.grid.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_fusion_matches_unsharded():
    """EKF fusion under GSPMD over the 8-device mesh: bit-identical
    tracks and covariances (VERDICT round-1 missing item 4)."""
    from micro_quad_slam_tpu.parallel import replay_fusion_sharded
    from micro_quad_slam_tpu.replay.fusion import (
        fusion_arrays, replay_fusion_batched)

    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    logs = [synth_room_scanlog(n_frames=20, seed=60 + s, path="circle",
                               noise_mm=4.0) for s in range(8)]
    frames = [fusion_arrays(lg) for lg in logs]
    batched = {k: np.stack([f[k] for f in frames]) for k in frames[0]}

    mesh = make_mesh(8)
    s_state, s_track = replay_fusion_sharded(batched, UL_PROFILE, mesh)
    u_state, u_track = replay_fusion_batched(
        {k: jnp.asarray(v) for k, v in batched.items()}, UL_PROFILE)
    np.testing.assert_array_equal(np.asarray(s_state.mean),
                                  np.asarray(u_state.mean))
    np.testing.assert_array_equal(np.asarray(s_state.cov),
                                  np.asarray(u_state.cov))
    for k in u_track:
        np.testing.assert_array_equal(np.asarray(s_track[k]),
                                      np.asarray(u_track[k]), err_msg=k)
    assert len(s_state.mean.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_slam_matches_unsharded():
    """Full SLAM pipeline under shard_map: bit-identical maps, tracks,
    and GN costs per flight."""
    from micro_quad_slam_tpu.parallel import slam_replay_sharded
    from micro_quad_slam_tpu.replay.fusion import fusion_arrays
    from micro_quad_slam_tpu.slam.pipeline import slam_replay

    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    logs = [synth_room_scanlog(n_frames=30, seed=70 + s, path="circle",
                               noise_mm=4.0) for s in range(8)]
    fr = [dict(scanlog_to_arrays(lg), **fusion_arrays(lg)) for lg in logs]
    batched = {k: np.stack([f[k] for f in fr]) for k in fr[0]}

    mesh = make_mesh(8)
    s_res = slam_replay_sharded(batched, UL_PROFILE, mesh, kf_every=10,
                                gn_iters=4)
    u_res = slam_replay({k: jnp.asarray(v) for k, v in batched.items()},
                        UL_PROFILE, kf_every=10, gn_iters=4)
    np.testing.assert_array_equal(np.asarray(s_res.grid),
                                  np.asarray(u_res.grid))
    np.testing.assert_array_equal(np.asarray(s_res.track),
                                  np.asarray(u_res.track))
    np.testing.assert_array_equal(np.asarray(s_res.gn_costs),
                                  np.asarray(u_res.gn_costs))
    np.testing.assert_array_equal(np.asarray(s_res.kf_idx),
                                  np.asarray(u_res.kf_idx))
    assert len(s_res.grid.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_sim_matches_unsharded():
    """Closed-loop swarm sim under GSPMD over the mesh: the jax.random
    noise streams depend only on global shapes, which GSPMD preserves,
    so the sharded run is bit-identical to the unsharded one."""
    from micro_quad_slam_tpu.models.simulator import (
        make_world, sim_init, sim_run)
    from micro_quad_slam_tpu.parallel import sim_run_sharded

    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    B = 8
    world = make_world(B, room=(-3.0, -3.0, 3.0, 3.0),
                       obstacles=[(1.2, -0.4, 1.9, 0.4)])
    st0 = sim_init(B, jax.random.PRNGKey(3), spread_m=0.5)

    mesh = make_mesh(8)
    s_st, s_diag = sim_run_sharded(st0, world, 40, UL_PROFILE, mesh,
                                   dt_ms=20, scan_period_ms=100)
    u_st, u_diag = sim_run(st0, world, 40, UL_PROFILE, dt_ms=20,
                           scan_period_ms=100)
    np.testing.assert_array_equal(np.asarray(s_st.x), np.asarray(u_st.x))
    np.testing.assert_array_equal(np.asarray(s_st.mapper.grid),
                                  np.asarray(u_st.mapper.grid))
    np.testing.assert_array_equal(np.asarray(s_st.beh.st),
                                  np.asarray(u_st.beh.st))
    for k in sorted(set(u_diag) & set(s_diag))[:4]:
        np.testing.assert_array_equal(np.asarray(s_diag[k]),
                                      np.asarray(u_diag[k]), err_msg=k)
    assert len(s_st.x.sharding.device_set) == 8
