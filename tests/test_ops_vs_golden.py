"""Device kernels vs golden C-semantics model: exact-equality tests.

Every op in micro_quad_slam_tpu.ops must reproduce the golden model
bit-for-bit (int8 grids) / to float32 exactness (beams, filters).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from micro_quad_slam_tpu.golden.model import GoldenMapper, compute_beams_and_minima, tof_filter_step
from micro_quad_slam_tpu.ops import (
    apply_scan_to_grid,
    extract_beams,
    frontier_scores,
    logical_grid,
    new_padded_grid,
    recenter_grid,
    tof_filter_update,
)
from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM
from micro_quad_slam_tpu.utils.config import MapConfig

CFG = MapConfig()
GEOM = DEFAULT_GEOM
F32 = np.float32


def random_grid_mm(rng, shape=(4, 8, 8)):
    """u16 sensor grids with realistic pathologies."""
    g = rng.integers(1, 4500, size=shape).astype(np.uint16)
    kind = rng.random(shape)
    g[kind < 0.10] = 0          # no return
    g[(kind >= 0.10) & (kind < 0.20)] = 0xFFFF  # dead zone
    g[(kind >= 0.20) & (kind < 0.25)] = rng.integers(1, 30)  # too close
    g[(kind >= 0.25) & (kind < 0.30)] = rng.integers(4000, 9000)  # over-range
    return g


# ---------------------------------------------------------------- beams ---

def test_beams_match_golden_random():
    rng = np.random.default_rng(0)
    jex = jax.jit(lambda g: extract_beams(g))
    for _ in range(20):
        g = random_grid_mm(rng)
        beams_j, min_j = jex(g)
        beams_g, min_g = compute_beams_and_minima(g)
        np.testing.assert_array_equal(np.asarray(beams_j), beams_g)
        np.testing.assert_array_equal(np.asarray(min_j), min_g)


def test_beams_duplicate_minima():
    g = np.full((4, 8, 8), 0, np.uint16)
    g[0, 0, 0] = 1000
    g[0, 3, 0] = 1000
    beams, _ = extract_beams(g)
    assert abs(float(beams[0, 0]) - 1.0) < 1e-7  # second element == dup


def test_filter_matches_golden():
    rng = np.random.default_rng(1)
    filt_j = jnp.full(4, jnp.nan)
    filt_g = np.full(4, np.nan, np.float32)
    for i in range(30):
        minima = rng.uniform(0.1, 4.0, 4).astype(np.float32)
        minima[rng.random(4) < 0.3] = np.nan
        filt_j = tof_filter_update(filt_j, jnp.asarray(minima))
        filt_g = tof_filter_step(filt_g, minima)
        np.testing.assert_array_equal(np.asarray(filt_j), filt_g)


# -------------------------------------------------------------- raycast ---

@jax.jit
def _scan_jit(padded, beams, x, y, yaw, ox, oy, enabled):
    return apply_scan_to_grid(padded, beams, x, y, yaw, ox, oy, enabled, CFG)


def _pad(grid_np):
    padded = new_padded_grid()
    return padded.at[GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500].set(grid_np)


def _jax_single_scan(grid_np, beams, x, y, yaw, ox, oy):
    out = _scan_jit(_pad(grid_np), jnp.asarray(beams), F32(x), F32(y),
                    F32(yaw), F32(ox), F32(oy), True)
    return np.asarray(logical_grid(out))


def _golden_single_scan(grid_np, beams, x, y, yaw, ox, oy):
    m = GoldenMapper(CFG)
    m.init_map(ox, oy)
    m.grid[:] = grid_np
    m.map_update_from_beams(beams, x, y, yaw)
    return m.grid


@pytest.mark.parametrize("seed", range(6))
def test_scan_update_matches_golden_random(seed):
    rng = np.random.default_rng(seed)
    grid0 = rng.integers(-80, 81, size=(500, 500)).astype(np.int8)
    beams = rng.uniform(0.03, 4.2, size=(4, 8)).astype(np.float32)
    beams[rng.random((4, 8)) < 0.15] = np.nan
    x, y = rng.uniform(-20, 20, 2)
    yaw = rng.uniform(-180, 180)
    g_j = _jax_single_scan(grid0, beams, x, y, yaw, 0.0, 0.0)
    g_g = _golden_single_scan(grid0, beams, x, y, yaw, 0.0, 0.0)
    np.testing.assert_array_equal(g_j, g_g)


def test_scan_update_near_saturation_order_sensitivity():
    # near-saturated initial grid makes the clamp ORDER observable:
    # sum-then-clamp would differ, sequential-exact must match golden.
    rng = np.random.default_rng(99)
    grid0 = rng.choice(
        np.array([-80, -79, -78, 78, 79, 80], np.int8), size=(500, 500)
    )
    for trial in range(4):
        beams = rng.uniform(0.1, 1.2, size=(4, 8)).astype(np.float32)
        x, y, yaw = 0.1 * trial, -0.05 * trial, 37.0 * trial
        g_j = _jax_single_scan(grid0, beams, x, y, yaw, 0.0, 0.0)
        g_g = _golden_single_scan(grid0, beams, x, y, yaw, 0.0, 0.0)
        np.testing.assert_array_equal(g_j, g_g)


def test_scan_update_bresenham_exhaustive_small():
    # single-beam scans sweeping many angles/distances: pins the closed-form
    # Bresenham membership against the reference walk in all octants.
    grid0 = np.zeros((500, 500), np.int8)
    for yaw in np.arange(0.0, 360.0, 11.25):
        beams = np.full((4, 8), np.nan, np.float32)
        beams[0, 3] = 3.7
        beams[2, 5] = 1.3
        g_j = _jax_single_scan(grid0, beams, 0.0, 0.0, yaw, 0.0, 0.0)
        g_g = _golden_single_scan(grid0, beams, 0.0, 0.0, yaw, 0.0, 0.0)
        np.testing.assert_array_equal(g_j, g_g)


def test_scan_update_pose_near_edges():
    rng = np.random.default_rng(5)
    grid0 = np.zeros((500, 500), np.int8)
    # pose close to each map corner/edge: rays with OOB endpoints are
    # skipped entirely (world_to_grid early-out), in-bounds rays applied
    for x, y in [(-24.9, -24.9), (24.9, 24.9), (0.0, -24.8), (24.8, 0.0),
                 (-26.0, 0.0), (60.0, 60.0)]:
        beams = rng.uniform(0.1, 4.0, size=(4, 8)).astype(np.float32)
        g_j = _jax_single_scan(grid0, beams, x, y, 10.0, 0.0, 0.0)
        g_g = _golden_single_scan(grid0, beams, x, y, 10.0, 0.0, 0.0)
        np.testing.assert_array_equal(g_j, g_g)


def test_scan_update_disabled_is_identity():
    rng = np.random.default_rng(6)
    grid0 = rng.integers(-80, 81, size=(500, 500)).astype(np.int8)
    beams = rng.uniform(0.1, 4.0, size=(4, 8)).astype(np.float32)
    out = _scan_jit(_pad(grid0), jnp.asarray(beams), F32(0), F32(0),
                    F32(0), F32(0), F32(0), False)
    np.testing.assert_array_equal(np.asarray(logical_grid(out)), grid0)


# ------------------------------------------------------------- recenter ---

@pytest.mark.parametrize("pose", [(16.0, 0.0), (-17.5, 3.0), (14.0, -16.2),
                                  (24.0, 24.0), (5.0, 5.0)])
def test_recenter_matches_golden(pose):
    rng = np.random.default_rng(7)
    grid0 = rng.integers(-80, 81, size=(500, 500)).astype(np.int8)

    gm = GoldenMapper(CFG)
    gm.init_map(0.0, 0.0)
    gm.grid[:] = grid0
    gm.recenter_if_needed(*pose)

    rc_jit = jax.jit(
        lambda p, ox, oy, x, y: recenter_grid(p, ox, oy, x, y, True, CFG)
    )
    out, ox, oy, did = rc_jit(_pad(grid0), F32(0.0), F32(0.0),
                              F32(pose[0]), F32(pose[1]))
    np.testing.assert_array_equal(np.asarray(logical_grid(out)), gm.grid)
    assert abs(float(ox) - float(gm.origin_x)) < 1e-6
    assert abs(float(oy) - float(gm.origin_y)) < 1e-6
    # margins must remain zero
    full = np.asarray(out)
    assert full[: GEOM.pad].sum() == 0 and full[:, : GEOM.pad].sum() == 0


# ------------------------------------------------------------- frontier ---

def test_frontier_matches_golden():
    rng = np.random.default_rng(8)
    grid0 = rng.integers(-40, 41, size=(500, 500)).astype(np.int8)
    gm = GoldenMapper(CFG)
    gm.init_map(0.0, 0.0)
    gm.grid[:] = grid0

    padded = _pad(grid0)
    offs = (0.0, 90.0, -90.0, 180.0)
    fs_jit = jax.jit(
        lambda p, x, y, yaw: frontier_scores(
            p, x, y, yaw, offs, F32(0.0), F32(0.0), True, CFG
        )
    )
    for x, y, yaw in [(0.0, 0.0, 0.0), (1.3, -2.1, 47.0), (-24.2, 0.0, 180.0),
                      (10.0, 10.0, -90.0)]:
        sc_j = np.asarray(fs_jit(padded, F32(x), F32(y), F32(yaw)))
        sc_g = [gm.frontier_score_dir(x, y, yaw, o) for o in offs]
        np.testing.assert_array_equal(sc_j, sc_g)


@pytest.mark.slow
def test_mxu_kernel_matches_xla():
    """Matmul window-IO variant (contiguous row slabs + one-hot bf16 matmul
    column select) must be bit-identical to the XLA path."""
    from micro_quad_slam_tpu.ops.raycast import apply_scan_to_grid_mxu

    rng = np.random.default_rng(31)
    B = 4
    padded = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    padded[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = (
        rng.integers(-80, 81, (B, 500, 500)).astype(np.int8))
    beams = rng.uniform(0.05, 4.1, (B, 4, 8)).astype(np.float32)
    beams[rng.random((B, 4, 8)) < 0.1] = np.nan
    xs = rng.uniform(-20, 20, B).astype(np.float32)
    ys = rng.uniform(-20, 20, B).astype(np.float32)
    yaws = rng.uniform(-180, 180, B).astype(np.float32)
    en = jnp.asarray([True, True, False, True])
    z = jnp.zeros(B, jnp.float32)

    o_m = jax.jit(lambda g, b, x, y, w, e: apply_scan_to_grid_mxu(
        g, b, x, y, w, z, z, e, CFG))(
        jnp.asarray(padded), jnp.asarray(beams), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(yaws), en)
    o_x = jax.vmap(lambda g, b, x, y, w, e: apply_scan_to_grid(
        g, b, x, y, w, F32(0), F32(0), e, CFG))(
        jnp.asarray(padded), jnp.asarray(beams), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(yaws), en)
    np.testing.assert_array_equal(np.asarray(o_m), np.asarray(o_x))


@pytest.mark.slow
def test_mxu_replay_bit_matches_golden():
    from micro_quad_slam_tpu.golden import golden_replay_mapping
    from micro_quad_slam_tpu.replay import replay_mapping_batched, scanlog_to_arrays
    from micro_quad_slam_tpu.sim import synth_room_scanlog
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    log = synth_room_scanlog(n_frames=20, seed=33, noise_mm=5.0,
                             path="hover", yaw_rate_dps=25.0)
    frames = {k: v[None] for k, v in scanlog_to_arrays(log).items()}
    state, outs = replay_mapping_batched(frames, UL_PROFILE, kernel="mxu")
    mapper, _ = golden_replay_mapping(log)
    np.testing.assert_array_equal(
        np.asarray(logical_grid(state.grid))[0], mapper.grid)


@pytest.mark.slow
def test_mxu2_replay_bit_matches_golden():
    """The gather-free double-one-hot-matmul kernel (bf16 grid carry)
    must reproduce golden exactly after the int8 cast."""
    from micro_quad_slam_tpu.golden import golden_replay_mapping
    from micro_quad_slam_tpu.replay import replay_mapping_batched, scanlog_to_arrays
    from micro_quad_slam_tpu.sim import synth_room_scanlog
    from micro_quad_slam_tpu.utils.config import UL_PROFILE

    log = synth_room_scanlog(n_frames=18, seed=35, noise_mm=5.0,
                             path="hover", yaw_rate_dps=30.0)
    frames = {k: v[None] for k, v in scanlog_to_arrays(log).items()}
    state, outs = replay_mapping_batched(frames, UL_PROFILE, kernel="mxu2")
    mapper, _ = golden_replay_mapping(log)
    np.testing.assert_array_equal(
        np.asarray(logical_grid(state.grid))[0], mapper.grid)
