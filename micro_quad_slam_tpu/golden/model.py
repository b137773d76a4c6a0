"""Golden C-semantics model: a direct float32/int8 re-expression of the
reference's perception & mapping math (SURVEY.md §2B), used as the bit-match
oracle for the device kernels.

Everything here is deliberately *scalar-ish numpy*: clarity and exact
C-operation ordering over speed.  Semantics reproduced (with citations):

  * robust_col_dist_m — second-smallest valid return per column
    (uav_local_nav.c:1320-1342)
  * compute_beams_and_minima — 4x8 beams + per-dir minima
    (uav_local_nav.c:1344-1359)
  * raycast_update — integer Bresenham, log-odds -1 per free cell,
    +6 at a hit endpoint, -(1/2)==0 at a miss endpoint, clamp [-80,80],
    sequential per-cell clamping in ray order (uav_local_nav.c:241-278)
  * map_update_from_beams — 32 rays per scan, F,R,B,L x col 0..7 order,
    63 deg FOV column fan (uav_local_nav.c:280-306)
  * map_recenter — whole-cell grid shift when pose strays >15 m from
    origin (uav_local_nav.c:308-353)
  * frontier_score_dir — 3-ray unknown/free/occupied scoring
    (uav_local_nav.c:356-385)
  * tof EMA filter (uav_local_nav.c:1430-1438)

All float math is performed in numpy float32 to mirror the C `float`
arithmetic, including operation order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from micro_quad_slam_tpu.utils.config import MapConfig, TofConfig

F32 = np.float32
DEG2RAD_F32 = F32(math.pi) / F32(180.0)


def robust_col_dist_m(sensor_mm: np.ndarray, col: int, tof: TofConfig = TofConfig()) -> float:
    """Second-smallest valid return in one 8-row column; smallest if only one
    valid; NaN if none (single-outlier rejection, uav_local_nav.c:1320-1342).

    sensor_mm: u16 [8, 8] (row-major) for one direction.
    """
    best = F32(np.nan)
    second = F32(np.nan)
    for row in range(tof.rows):
        mm = int(sensor_mm[row, col])
        if mm == 0xFFFF or mm == 0:
            continue
        m = F32(mm) * F32(0.001)
        if m <= F32(tof.min_valid_m):
            continue
        if m > F32(tof.max_range_m):
            m = F32(tof.max_range_m)
        if np.isnan(best) or m < best:
            second = best
            best = m
        elif np.isnan(second) or m < second:
            second = m
    if not np.isnan(second):
        return float(second)
    return float(best)


def compute_beams_and_minima(
    grid_mm: np.ndarray, tof: TofConfig = TofConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """beams f32 [4, 8] and per-dir minima f32 [4] (uav_local_nav.c:1344-1359)."""
    beams = np.full((tof.num_dirs, tof.cols), np.nan, np.float32)
    minima = np.full(tof.num_dirs, np.nan, np.float32)
    for d in range(tof.num_dirs):
        dir_min = F32(np.nan)
        for c in range(tof.cols):
            m = F32(robust_col_dist_m(grid_mm[d], c, tof))
            beams[d, c] = m
            if not np.isnan(m) and (np.isnan(dir_min) or m < dir_min):
                dir_min = m
        minima[d] = dir_min
    return beams, minima


def tof_filter_step(
    filt: np.ndarray, minima: np.ndarray, alpha: float = 0.20
) -> np.ndarray:
    """EMA on per-direction minima; NaN-aware init (uav_local_nav.c:1430-1438)."""
    out = filt.astype(np.float32).copy()
    a = F32(alpha)
    one_m_a = F32(1.0) - a
    for d in range(4):
        v = F32(minima[d])
        if np.isnan(v):
            continue
        if np.isnan(out[d]):
            out[d] = v
        else:
            out[d] = one_m_a * out[d] + a * v
    return out


class GoldenMapper:
    """Stateful log-odds occupancy grid with the reference's exact update,
    recenter, and frontier semantics."""

    def __init__(self, cfg: MapConfig = MapConfig(), tof: TofConfig = TofConfig()):
        self.cfg = cfg
        self.tof = tof
        self.grid = np.zeros((cfg.height, cfg.width), np.int8)  # [y, x]
        self.inited = False
        self.origin_x = F32(np.nan)
        self.origin_y = F32(np.nan)
        self.recentered = False  # KF_MAP_RECENTER pending flag analog

    # -- grid addressing (uav_local_nav.c:205-216) --
    def world_to_grid(self, x: float, y: float) -> Optional[Tuple[int, int]]:
        if not self.inited:
            return None
        dx = F32(x) - self.origin_x
        dy = F32(y) - self.origin_y
        # lrintf == round-half-to-even, same as np.rint
        ix = int(np.rint(dx / F32(self.cfg.res_m))) + self.cfg.width // 2
        iy = int(np.rint(dy / F32(self.cfg.res_m))) + self.cfg.height // 2
        if ix < 0 or ix >= self.cfg.width or iy < 0 or iy >= self.cfg.height:
            return None
        return ix, iy

    def init_map(self, origin_x: float, origin_y: float) -> None:
        """Map init at hover lock (uav_local_nav.c:2187-2194)."""
        self.origin_x = F32(origin_x)
        self.origin_y = F32(origin_y)
        self.grid[:] = 0
        self.inited = True

    def _clamp_lo(self, v: int) -> int:
        return max(self.cfg.lo_min, min(self.cfg.lo_max, v))

    def raycast_update(
        self, x0: float, y0: float, x1: float, y1: float, hit_occ: bool
    ) -> None:
        """Integer Bresenham walk with per-step clamped log-odds updates
        (uav_local_nav.c:241-278)."""
        p0 = self.world_to_grid(x0, y0)
        if p0 is None:
            return
        p1 = self.world_to_grid(x1, y1)
        if p1 is None:
            return
        x0g, y0g = p0
        x1g, y1g = p1

        dx = abs(x1g - x0g)
        sx = 1 if x0g < x1g else -1
        dy = -abs(y1g - y0g)
        sy = 1 if y0g < y1g else -1
        err = dx + dy
        x, y = x0g, y0g

        while True:
            is_end = x == x1g and y == y1g
            if not is_end:
                self.grid[y, x] = self._clamp_lo(
                    int(self.grid[y, x]) - self.cfg.lo_free_dec
                )
            else:
                if hit_occ:
                    self.grid[y, x] = self._clamp_lo(
                        int(self.grid[y, x]) + self.cfg.lo_occ_inc
                    )
                else:
                    # LO_FREE_DEC/2 == 0: miss endpoint unchanged
                    # (uav_local_nav.c:266)
                    self.grid[y, x] = self._clamp_lo(
                        int(self.grid[y, x]) - self.cfg.lo_miss_end_dec
                    )
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x += sx
            if e2 <= dx:
                err += dx
                y += sy
            if x < 0 or x >= self.cfg.width or y < 0 or y >= self.cfg.height:
                break

    def map_update_from_beams(
        self, beams: np.ndarray, x_m: float, y_m: float, yaw_deg: float
    ) -> None:
        """32-ray scan projection (uav_local_nav.c:280-306).  Ray order is
        F0..F7, R0..R7, B0..B7, L0..L7 — this order is observable through
        int8 clamping and must be preserved."""
        if not self.inited:
            return
        half_fov = F32(self.tof.fov_deg) * F32(0.5)
        for d in range(4):
            for c in range(self.tof.cols):
                dist = F32(beams[d, c])
                if np.isnan(dist):
                    continue
                if dist <= F32(self.tof.map_skip_below_m):
                    continue
                hit_occ = bool(
                    dist < (F32(self.tof.max_range_m) - F32(self.tof.hit_margin_m))
                )
                if dist > F32(self.tof.max_range_m):
                    dist = F32(self.tof.max_range_m)
                u = (F32(c) - F32(3.5)) / F32(3.5)
                col_off = u * half_fov
                ang_deg = F32(yaw_deg) + F32(self.tof.dir_center_deg[d]) + col_off
                ang = ang_deg * DEG2RAD_F32
                ex = F32(x_m) + dist * np.cos(ang, dtype=np.float32)
                ey = F32(y_m) + dist * np.sin(ang, dtype=np.float32)
                self.raycast_update(x_m, y_m, float(ex), float(ey), hit_occ)

    def recenter_if_needed(self, x_m: float, y_m: float) -> bool:
        """Shift the grid by whole cells when the pose strays beyond 60% of
        the half-size from the origin (uav_local_nav.c:324-353)."""
        if not self.inited:
            return False
        half = F32(self.cfg.size_m) * F32(0.5)
        thresh = half * F32(self.cfg.recenter_frac)
        dx = F32(x_m) - self.origin_x
        dy = F32(y_m) - self.origin_y
        if abs(dx) < thresh and abs(dy) < thresh:
            return False
        sx = int(np.rint(dx / F32(self.cfg.res_m)))
        sy = int(np.rint(dy / F32(self.cfg.res_m)))
        mx = self.cfg.recenter_max_shift_cells
        sx = max(-mx, min(mx, sx))
        sy = max(-mx, min(mx, sy))
        if sx == 0 and sy == 0:
            return False
        # new[y, x] = old[y + sy, x + sx], zero where out of range
        # (uav_local_nav.c:308-322)
        h, w = self.cfg.height, self.cfg.width
        tmp = np.zeros_like(self.grid)
        ys = slice(max(0, -sy), min(h, h - sy))
        xs = slice(max(0, -sx), min(w, w - sx))
        ys_src = slice(ys.start + sy, ys.stop + sy)
        xs_src = slice(xs.start + sx, xs.stop + sx)
        tmp[ys, xs] = self.grid[ys_src, xs_src]
        self.grid = tmp
        self.origin_x = self.origin_x + F32(sx) * F32(self.cfg.res_m)
        self.origin_y = self.origin_y + F32(sy) * F32(self.cfg.res_m)
        self.recentered = True
        return True

    def frontier_score_dir(
        self, x_m: float, y_m: float, yaw_deg: float, offset_deg: float
    ) -> int:
        """3-ray unknown/free/occupied scoring (uav_local_nav.c:356-385).
        The `d += step` float accumulation is reproduced exactly (the loop
        bound is float-sensitive)."""
        if not self.inited:
            return 0
        cfg = self.cfg
        step = F32(cfg.res_m) * F32(cfg.frontier_step_cells)
        max_range = F32(cfg.frontier_range_m)
        unknown = free = occ = 0
        for off in cfg.frontier_ray_offsets_deg:
            ang = (F32(yaw_deg) + F32(offset_deg) + F32(off)) * DEG2RAD_F32
            ca = np.cos(ang, dtype=np.float32)
            sa = np.sin(ang, dtype=np.float32)
            d = step
            while d <= max_range:
                px = F32(x_m) + d * ca
                py = F32(y_m) + d * sa
                p = self.world_to_grid(float(px), float(py))
                if p is None:
                    break
                v = int(self.grid[p[1], p[0]])
                if -cfg.frontier_unknown_band <= v <= cfg.frontier_unknown_band:
                    unknown += 1
                elif v > cfg.frontier_occ_thresh:
                    occ += 1
                elif v < cfg.frontier_free_thresh:
                    free += 1
                d = d + step
        return (
            unknown * cfg.frontier_w_unknown
            + free * cfg.frontier_w_free
            - occ * cfg.frontier_w_occ
        )


def frontier_score_dir(
    mapper: GoldenMapper, x_m: float, y_m: float, yaw_deg: float, offset_deg: float
) -> int:
    return mapper.frontier_score_dir(x_m, y_m, yaw_deg, offset_deg)


def _sys_bit_ok(sys_health: int, bit: int) -> bool:
    """Health-bit proxy for replay: sys_health==0 means 'no SYS_STATUS seen'
    (scanrec stores 0 then, uav_local_nav.c:1576) => treat as healthy, same
    as the reference's stale-SYS fallback (uav_local_nav.c:904-907)."""
    if sys_health == 0:
        return True
    return (sys_health & bit) != 0


# MAV_SYS_STATUS sensor bits used by the gates (values from MAVLink common)
SENSOR_XY_POSITION_CONTROL = 0x4000
SENSOR_Z_ALTITUDE_CONTROL = 0x2000
SENSOR_3D_GYRO = 0x01
SENSOR_MOTOR_OUTPUTS = 0x400000


def pose_good_for_mapping_rec(
    x_m: float, yaw_deg: float, of_q: int, of_rate_x: float,
    sys_health: int, of_min_quality: int = 50,
) -> bool:
    """Replay-time reconstruction of pose_good_for_mapping
    (uav_local_nav.c:935-947) from a scanrec:

      * lpos fresh  <=> x_m finite (the writer NaNs x when !have_xy,
        uav_local_nav.c:1559, and have_xy == lpos_fresh, :1447)
      * have_att    <=> yaw finite (:1561)
      * XY/Z ctrl   from recorded sys_health (0 => no data => healthy)
      * flow fresh  <=> recorded rates finite; then quality gate applies
    """
    if not np.isfinite(x_m):
        return False
    if not np.isfinite(yaw_deg):
        return False
    if not _sys_bit_ok(sys_health, SENSOR_XY_POSITION_CONTROL):
        return False
    if not _sys_bit_ok(sys_health, SENSOR_Z_ALTITUDE_CONTROL):
        return False
    if np.isfinite(of_rate_x) and of_q < of_min_quality:
        return False
    return True


# States (uav_local_nav.c:484-496)
ST_WAIT_LINK, ST_IDLE, ST_ARMING, ST_TAKEOFF, ST_LIFTOFF_ASSIST = 0, 1, 2, 3, 4
ST_HOVER, ST_EXPLORE, ST_TURNING, ST_LANDING, ST_DISARMING = 5, 6, 7, 8, 9
AIRBORNE_STATES = (ST_HOVER, ST_EXPLORE, ST_TURNING, ST_LANDING)


def golden_replay_mapping(
    scanlog, cfg: MapConfig = MapConfig(), tof: TofConfig = TofConfig(),
    of_min_quality: int = 50, airborne_states: tuple = AIRBORNE_STATES,
):
    """Replay a ScanLog through the golden mapper: the reference's offline
    mapping pipeline (call stack SURVEY.md §3.2) recomputed from logged poses.

    Replay policy (deterministic from the log alone; identical policy is
    implemented by the device pipeline so the two bit-match):
      * map init at the first record with finite (x, y) and an airborne
        state (the reference inits at hover XY lock, uav_local_nav.c:2187);
        origin = that record's pose.
      * per record: recenter-if-needed when (x, y) finite, then update iff
        pose_good_for_mapping_rec.

    Returns (mapper, used_mask) where used_mask[t] marks records that
    actually updated the map.
    """
    mapper = GoldenMapper(cfg, tof)
    T = len(scanlog)
    used = np.zeros(T, bool)
    filt = np.full(4, np.nan, np.float32)
    for t in range(T):
        beams, minima = compute_beams_and_minima(scanlog.grid_mm[t], tof)
        filt = tof_filter_step(filt, minima, tof.filt_alpha)
        x = float(scanlog.x_m[t])
        y = float(scanlog.y_m[t])
        yaw = float(scanlog.yaw_deg[t])
        st = int(scanlog.state[t])
        if not mapper.inited:
            if np.isfinite(x) and np.isfinite(y) and st in airborne_states:
                mapper.init_map(x, y)
            else:
                continue
        if np.isfinite(x) and np.isfinite(y):
            mapper.recenter_if_needed(x, y)
        if pose_good_for_mapping_rec(
            x, yaw, int(scanlog.of_q[t]), float(scanlog.of_rate_x[t]),
            int(scanlog.sys_health[t]), of_min_quality,
        ):
            mapper.map_update_from_beams(beams, x, y, yaw)
            used[t] = True
    return mapper, used
