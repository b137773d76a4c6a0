"""Golden C-semantics model tests — pin the reference's exact math
(SURVEY.md §2B) before the device kernels are held to it.
"""

import numpy as np

from micro_quad_slam_tpu.golden.model import (
    GoldenMapper,
    compute_beams_and_minima,
    golden_replay_mapping,
    robust_col_dist_m,
    tof_filter_step,
)
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import MapConfig


def _col(vals_mm):
    """Build an 8x8 sensor grid with a given column 0 (rest dead)."""
    g = np.full((8, 8), 0xFFFF, np.uint16)
    for r, v in enumerate(vals_mm):
        g[r, 0] = v
    return g


def test_robust_col_second_min():
    # second-smallest valid wins (single-outlier rejection,
    # uav_local_nav.c:1320-1342)
    g = _col([500, 2000, 1500, 0xFFFF, 0, 3000, 0xFFFF, 0xFFFF])
    assert abs(robust_col_dist_m(g, 0) - 1.5) < 1e-6


def test_robust_col_single_valid_and_none():
    assert abs(robust_col_dist_m(_col([800] + [0] * 7), 0) - 0.8) < 1e-6
    assert np.isnan(robust_col_dist_m(_col([0] * 8), 0))
    # <= 0.02 m rejected (uav_local_nav.c:1329).  Float32 subtlety: 20 mm
    # * 0.001f = 0.0200000014 > 0.02f = 0.0199999996, so 20 mm is KEPT by
    # the reference; 19 mm is rejected.
    assert np.isnan(robust_col_dist_m(_col([19, 15] + [0] * 6), 0))
    assert abs(robust_col_dist_m(_col([20, 15] + [0] * 6), 0) - 0.02) < 1e-6


def test_robust_col_clamps_to_max_range():
    # two returns over 4 m both clamp to 4.0; second-min == 4.0
    g = _col([4500, 5000] + [0] * 6)
    assert abs(robust_col_dist_m(g, 0) - 4.0) < 1e-6


def test_beams_and_minima_shape():
    grid = np.full((4, 8, 8), 1234, np.uint16)
    beams, minima = compute_beams_and_minima(grid)
    assert beams.shape == (4, 8)
    np.testing.assert_allclose(beams, 1.234, rtol=1e-6)
    np.testing.assert_allclose(minima, 1.234, rtol=1e-6)


def test_tof_filter_nan_init_and_ema():
    filt = np.full(4, np.nan, np.float32)
    filt = tof_filter_step(filt, np.array([1.0, np.nan, 2.0, 3.0], np.float32))
    assert abs(filt[0] - 1.0) < 1e-7 and np.isnan(filt[1])
    filt = tof_filter_step(filt, np.array([2.0, np.nan, 2.0, 1.0], np.float32))
    assert abs(filt[0] - (0.8 * 1.0 + 0.2 * 2.0)) < 1e-6
    assert np.isnan(filt[1])


def test_raycast_free_and_hit():
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    # ray along +x for 1.0 m, hit at the end
    m.raycast_update(0.0, 0.0, 1.0, 0.0, True)
    cy, cx = 250, 250
    # cells 0..9 along x decremented, endpoint cell +6
    for k in range(10):
        assert m.grid[cy, cx + k] == -1, k
    assert m.grid[cy, cx + 10] == 6


def test_raycast_miss_endpoint_unchanged():
    # LO_FREE_DEC/2 == 0 quirk (uav_local_nav.c:266)
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    m.raycast_update(0.0, 0.0, 1.0, 0.0, False)
    assert m.grid[250, 260] == 0
    assert m.grid[250, 255] == -1


def test_raycast_clamp_sequential_order_visible():
    # A cell saturated at +80 then decremented must end at 79 (sequential),
    # not 80 (sum-then-clamp): the op ORDER is observable through clamping.
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    m.grid[250, 260] = 79
    m.raycast_update(0.0, 0.0, 1.0, 0.0, True)   # +6 -> clamp 80
    assert m.grid[250, 260] == 80
    m.raycast_update(0.0, 0.0, 2.0, 0.0, True)   # passes through as free: -1
    assert m.grid[250, 260] == 79


def test_raycast_skips_out_of_bounds_endpoint():
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    m.raycast_update(0.0, 0.0, 30.0, 0.0, True)  # endpoint beyond 25 m: no-op
    assert not m.grid.any()


def test_grid_bounds_property():
    # grid stays within [-80, 80] under many updates
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    for _ in range(30):
        m.raycast_update(0.0, 0.0, 0.5, 0.0, True)
    assert m.grid.max() <= 80 and m.grid.min() >= -80
    assert m.grid[250, 255] == 80  # saturated endpoint


def test_recenter_preserves_content_modulo_shift():
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    m.grid[250, 260] = 42
    m.grid[100, 100] = -7
    assert m.recenter_if_needed(16.0, 0.0)  # 16 m > 15 m threshold
    # raw shift would be 160 cells but is clamped to 125
    # (uav_local_nav.c:337-341): new[y, x] = old[y, x+125]
    assert m.grid[250, 260 - 125] == 42
    assert abs(m.origin_x - 12.5) < 1e-6
    assert m.grid[100, 100] == 0  # old content shifted away
    assert m.recentered


def test_recenter_clamps_shift():
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    assert m.recenter_if_needed(24.0, 0.0)  # 240 cells -> clamped to 125
    assert abs(m.origin_x - 12.5) < 1e-6


def test_recenter_below_threshold_noop():
    m = GoldenMapper()
    m.init_map(0.0, 0.0)
    assert not m.recenter_if_needed(14.9, 14.9)


def test_frontier_scoring():
    cfg = MapConfig()
    m = GoldenMapper(cfg)
    m.init_map(0.0, 0.0)
    # all unknown ahead: 3 rays x 12 steps x 3 = 108
    assert m.frontier_score_dir(0.0, 0.0, 0.0, 0.0) == 108
    # carve free space ahead -> lower score (free worth 1 vs unknown 3)
    m.grid[245:256, 250:276] = -20
    s_free = m.frontier_score_dir(0.0, 0.0, 0.0, 0.0)
    assert s_free < 108
    # wall ahead -> negative contribution
    m.grid[245:256, 255:258] = 30
    assert m.frontier_score_dir(0.0, 0.0, 0.0, 0.0) < s_free


def test_golden_replay_builds_walls():
    log = synth_room_scanlog(n_frames=24, room=(-2.0, -2.0, 2.0, 2.0),
                             path="hover", yaw_rate_dps=15.0)
    mapper, used = golden_replay_mapping(log)
    assert used.all()
    assert mapper.inited
    occ = (mapper.grid > 10).sum()
    free = (mapper.grid < -10).sum()
    assert occ > 20      # wall cells accumulated
    assert free > 200    # interior carved free
    # walls are ~2 m away: occupied cells near ring of radius 20 cells
    ys, xs = np.nonzero(mapper.grid > 10)
    r = np.hypot(ys - 250.0, xs - 250.0)
    assert r.min() > 15 and r.max() < 32
