"""Correlative scan matching: refine a pose guess against the occupancy
grid (new capability — the reference dead-reckons on the FC's EKF with no
drift correction; BASELINE.json config 4 adds scan-matching + pose-graph
refinement on top).

Design: instead of an iterative point-to-plane ICP with
data-dependent convergence, score a STATIC dense candidate lattice
(translations x rotations around the guess) in one shot — every candidate
evaluates all 32 beam endpoints against the grid in parallel, the argmax
wins, and a quadratic fit around the peak gives sub-cell resolution.
Fixed shapes, no loops, vmaps over quads.

Cell lookups go through one [96, 128] window slice around the guess and
TWO one-hot matmuls per lattice ((rows @ window) * cols summed) instead
of an advanced-indexing gather with traced indices.  Every candidate cell provably falls inside the window (max beam reach 4.0 m +
search radius < window margins), and out-of-grid candidates score 0
through the no-match row of the one-hot, identical to the masked-gather
semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM, GridGeom, world_to_cell
from micro_quad_slam_tpu.utils.config import MapConfig, TofConfig

_F32 = np.float32
_DEG2RAD = _F32(np.pi / 180.0)


def _assert_window_fits(cfg: MapConfig, geom: GridGeom, n_xy: int,
                        xy_step_m: float) -> None:
    """Static (trace-time) containment proof: every reachable candidate
    endpoint cell falls inside the [win_rows, win_cols] window centered
    on the pose cell — max beam reach + translation-search radius +
    rounding must fit the half-window margins.  Custom geometries (finer
    res / longer range) that break this would silently score 0 for the
    out-of-window cells otherwise (advisor finding, round 2)."""
    search_cells = int(np.ceil((n_xy - 1) / 2 * xy_step_m / cfg.res_m))
    reach = cfg.max_ray_cells + search_cells + 1   # +1 lrintf rounding
    half_r = geom.win_rows // 2
    half_c = geom.win_cols // 2
    if reach > min(half_r, half_c - 1):
        raise ValueError(
            f"scan-match window too small: beam reach {cfg.max_ray_cells} "
            f"+ search {search_cells} cells exceeds the "
            f"[{geom.win_rows}, {geom.win_cols}] window margins; enlarge "
            f"GridGeom.win_rows/win_cols for this MapConfig")


class MatchResult(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    yaw_deg: jnp.ndarray
    score: jnp.ndarray       # best lattice score (sum of endpoint log-odds)
    quality: jnp.ndarray     # peak minus mean score (confidence proxy)


def _endpoints_world(beams, x, y, yaw_deg, tof: TofConfig):
    """Hit endpoints [32, 2] + hit mask [32] for one scan (same fan
    geometry as the mapper, uav_local_nav.c:280-301)."""
    half_fov = _F32(tof.half_fov_deg)
    u = (np.arange(8, dtype=np.float32) - _F32(3.5)) / _F32(3.5)
    centers = np.asarray(tof.dir_center_deg, np.float32)
    dist = beams.reshape(4, 8)
    hit = (~jnp.isnan(dist)) & (dist > _F32(tof.map_skip_below_m)) & (
        dist < _F32(tof.max_range_m) - _F32(tof.hit_margin_m))
    d = jnp.where(hit, dist, 0.0)
    ang = ((yaw_deg + centers[:, None]) + (u * half_fov)[None, :]) * _DEG2RAD
    ex = x + d * jnp.cos(ang)
    ey = y + d * jnp.sin(ang)
    return (jnp.stack([ex.reshape(32), ey.reshape(32)], axis=-1),
            hit.reshape(32))


def _lattice_cells(beams, x_guess, y_guess, yaw_guess_deg, origin_x,
                   origin_y, cfg: MapConfig, tof: TofConfig,
                   n_xy: int, n_yaw: int, xy_step_m: float,
                   yaw_step_deg: float):
    """Candidate endpoint CELLS for the (n_yaw, n_xy, n_xy) lattice.
    Returns (cy [Y, 32, Ty], cx [Y, 32, Tx], iny, inx, hit [Y, 32])."""
    offs_xy = (np.arange(n_xy, dtype=np.float32)
               - (n_xy - 1) / 2) * _F32(xy_step_m)
    offs_yaw = (np.arange(n_yaw, dtype=np.float32)
                - (n_yaw - 1) / 2) * _F32(yaw_step_deg)

    def yaw_endpoints(dyaw):
        return _endpoints_world(beams, x_guess, y_guess,
                                yaw_guess_deg + dyaw, tof)

    # vmap, NOT lax.map: the yaw axis is tiny and static, and lax.map
    # compiles to a sequential scan of 7 endpoint computations per match
    pts, hit = jax.vmap(yaw_endpoints)(jnp.asarray(offs_yaw))  # [Y, 32, 2]

    ex = pts[..., 0][:, :, None] + offs_xy[None, None, :]      # [Y, 32, Tx]
    ey = pts[..., 1][:, :, None] + offs_xy[None, None, :]      # [Y, 32, Ty]
    cx, cy = world_to_cell(ex, ey, origin_x, origin_y, cfg.res_m,
                           cfg.width // 2, cfg.height // 2)
    iny = (cy >= 0) & (cy < cfg.height)
    inx = (cx >= 0) & (cx < cfg.width)
    return cy, cx, iny, inx, hit


def _score_lattice(window, wy0, wx0, beams, x_guess, y_guess,
                   yaw_guess_deg, origin_x, origin_y,
                   cfg: MapConfig, tof: TofConfig, geom: GridGeom,
                   n_xy: int, n_yaw: int, xy_step_m: float,
                   yaw_step_deg: float):
    """Score the (n_yaw, n_xy, n_xy) candidate lattice against a
    [96, 128] int8 window whose top-left padded-grid cell is (wy0, wx0).
    Returns (scores [Y, Tx, Ty] f32, hit [Y, 32] bool).  Lookups are
    one-hot matmuls (exact: one-hot selectors and int8 values are
    bf16-representable); cells outside the window or the logical grid
    contribute 0.

    SEPARABLE lattice: the world offsets shift x and y independently,
    so the endpoint column index rx varies only over (Y, Tx, beam) and
    the row index ry only over (Y, Ty, beam) — the [Y*Tx*Ty*32, win]
    one-hot batch of the round-2 formulation factors into two small
    per-(Y, beam) matmuls: ~7x fewer FLOPs, and the largest
    intermediate shrinks from [N=10976, 128] f32 per match to
    [Y, 32, Ty, 128].  Per-entry values are identical: each
    output cell of BOTH dots sums exactly one nonzero product in f32
    (one-hot selectors; int8 grid values are bf16-representable), and
    the beam reduction keeps the same axis order as before.  Each side
    folds its own in-grid test (and the row side the hit mask) into its
    one-hot: the product is zero unless BOTH cell axes are in the
    logical grid and the beam hit."""
    _assert_window_fits(cfg, geom, n_xy, xy_step_m)
    cy, cx, iny, inx, hit = _lattice_cells(
        beams, x_guess, y_guess, yaw_guess_deg, origin_x, origin_y,
        cfg, tof, n_xy, n_yaw, xy_step_m, yaw_step_deg)
    ry = cy + geom.pad - wy0                                   # [Y, 32, Ty]
    rx = cx + geom.pad - wx0                                   # [Y, 32, Tx]
    rows = jnp.arange(window.shape[-2])
    cols = jnp.arange(window.shape[-1])
    R = ((ry[..., None] == rows) & iny[..., None]
         & hit[:, :, None, None]).astype(jnp.bfloat16)   # [Y, 32, Ty, 96]
    Cc = ((rx[..., None] == cols)
          & inx[..., None]).astype(jnp.bfloat16)         # [Y, 32, Tx, 128]
    T1 = lax.dot_general(R, window.astype(jnp.bfloat16),
                         (((3,), (0,)), ((), ())),
                         preferred_element_type=jnp.float32)  # [Y, 32, Ty, 128]
    M = lax.dot_general(T1.astype(jnp.bfloat16), Cc,
                        (((3,), (3,)), ((0, 1), (0, 1))),
                        preferred_element_type=jnp.float32)   # [Y, 32, Ty, Tx]
    vals = jnp.transpose(M, (0, 3, 2, 1))                     # [Y, Tx, Ty, 32]
    return vals.sum(axis=-1), hit


def _window_by_matmul(padded_grid, wy0, wx0, geom: GridGeom):
    """Slice the [win_rows, win_cols] window at (wy0, wx0) through two
    one-hot matmuls instead of a vmapped dynamic_slice with per-flight
    starts.  EXACT: int8 grid values and one-hot selectors are
    bf16-representable, and each output cell sums exactly one nonzero
    product in f32.  Returns f32."""
    bf = jnp.bfloat16
    rows = wy0 + jnp.arange(geom.win_rows)
    A = (rows[:, None] == jnp.arange(geom.prows)[None, :]).astype(bf)
    cols = wx0 + jnp.arange(geom.win_cols)
    Ct = (jnp.arange(geom.pcols)[:, None] == cols[None, :]).astype(bf)
    G = lax.dot_general(A, padded_grid.astype(bf),
                        (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
    return lax.dot_general(G.astype(bf), Ct, (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.float32)


def window_origin(pcx, pcy, geom: GridGeom = DEFAULT_GEOM):
    """Padded-grid top-left cell (wy0, wx0) of the [win_rows, win_cols]
    match window centered on pose cell (pcx, pcy)."""
    wy0 = jnp.clip(pcy + geom.pad - geom.win_rows // 2, 0,
                   geom.prows - geom.win_rows)
    wx0 = jnp.clip(pcx + geom.pad - geom.win_cols // 2, 0,
                   geom.pcols - geom.win_cols)
    return wy0, wx0


def match_window(window: jnp.ndarray, wy0, wx0, beams,
                 x_guess, y_guess, yaw_guess_deg, origin_x, origin_y,
                 cfg: MapConfig = MapConfig(), tof: TofConfig = TofConfig(),
                 geom: GridGeom = DEFAULT_GEOM, n_xy: int = 7,
                 n_yaw: int = 7, xy_step_m: float = 0.05,
                 yaw_step_deg: float = 1.0) -> MatchResult:
    """match_scan against a [96, 128] window (padded-grid top-left cell
    (wy0, wx0)) — cells outside the window read as 0 (unknown), which is
    exactly the semantics the loop-closure pass needs when matching
    against a single keyframe's local map."""
    scores, hit = _score_lattice(window, wy0, wx0, beams, x_guess,
                                 y_guess, yaw_guess_deg, origin_x,
                                 origin_y, cfg, tof, geom, n_xy, n_yaw,
                                 xy_step_m, yaw_step_deg)
    return _peak_result(scores, hit, x_guess, y_guess, yaw_guess_deg,
                        xy_step_m, yaw_step_deg)


def match_scan(
    padded_grid: jnp.ndarray,
    beams: jnp.ndarray,
    x_guess, y_guess, yaw_guess_deg,
    origin_x, origin_y,
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
    geom: GridGeom = DEFAULT_GEOM,
    n_xy: int = 7,           # translation lattice (n_xy x n_xy), odd
    n_yaw: int = 7,          # rotation lattice, odd
    xy_step_m: float = 0.05,
    yaw_step_deg: float = 1.0,
) -> MatchResult:
    """Score (n_yaw * n_xy^2) candidate poses; return the refined pose.

    Score of a candidate = sum over hit endpoints of the int8 log-odds at
    the endpoint cell — maximized when endpoints land on occupied cells.
    Sub-cell refinement: 1-D quadratic fit through the peak along each
    lattice axis.
    """
    pcx, pcy = world_to_cell(x_guess, y_guess, origin_x, origin_y,
                             cfg.res_m, cfg.width // 2, cfg.height // 2)
    wy0, wx0 = window_origin(pcx, pcy, geom)
    window = _window_by_matmul(padded_grid, wy0, wx0, geom)
    scores, hit = _score_lattice(window, wy0, wx0, beams, x_guess,
                                 y_guess, yaw_guess_deg, origin_x,
                                 origin_y, cfg, tof, geom, n_xy, n_yaw,
                                 xy_step_m, yaw_step_deg)

    return _peak_result(scores, hit, x_guess, y_guess, yaw_guess_deg,
                        xy_step_m, yaw_step_deg)


def _peak_result(scores, hit, x_guess, y_guess, yaw_guess_deg,
                 xy_step_m: float, yaw_step_deg: float) -> MatchResult:
    """Argmax over the lattice + per-axis quadratic sub-cell refinement
    -> MatchResult."""
    flat = scores.reshape(-1)
    best = jnp.argmax(flat)
    Y, TX, TY = scores.shape
    iy = best // (TX * TY)
    ix = (best // TY) % TX
    it = best % TY

    def subcell(arr_1d, idx, step):
        """Quadratic peak interpolation along one axis, clamped at edges."""
        n = arr_1d.shape[0]
        i0 = jnp.clip(idx, 1, n - 2)
        ym = arr_1d[i0 - 1]
        y0 = arr_1d[i0]
        yp = arr_1d[i0 + 1]
        denom = ym - 2 * y0 + yp
        d = jnp.where(jnp.abs(denom) > 1e-6,
                      _F32(0.5) * (ym - yp) / denom, 0.0)
        d = jnp.clip(d, -1.0, 1.0)
        interior = (idx >= 1) & (idx <= n - 2)
        return (idx.astype(jnp.float32)
                + jnp.where(interior, d, 0.0) - (n - 1) / 2) * _F32(step)

    dyaw = subcell(scores[:, ix, it], iy, yaw_step_deg)
    dx = subcell(scores[iy, :, it], ix, xy_step_m)
    dy = subcell(scores[iy, ix, :], it, xy_step_m)

    nhit = jnp.maximum(hit.sum(axis=-1)[iy].astype(jnp.float32), 1.0)
    quality = (flat[best] - flat.mean()) / nhit
    return MatchResult(
        x=x_guess + dx,
        y=y_guess + dy,
        yaw_deg=yaw_guess_deg + dyaw,
        score=flat[best],
        quality=quality,
    )
