"""Fused scan -> log-odds grid update, as dense vectorized work.

The reference's hot loop (SURVEY.md §3.2) walks 32 Bresenham rays per scan,
mutating int8 cells one at a time with saturating log-odds updates
(raycast_update, uav_local_nav.c:241-278; map_update_from_beams, :280-306).
This module re-derives the update without data-dependent scatter, as
dense, vectorized work with *identical* results:

1.  **No scatter, no bounds-break.**  The reference only casts a ray when
    BOTH the pose cell and the endpoint cell are inside the 500x500 grid
    (world_to_grid early-outs, :243-244); a Bresenham walk between two
    in-bounds cells never leaves the grid (it stays in the endpoints'
    bounding box), so the mid-walk bounds check (:276) is dead code and
    per-ray validity is a single predicate.

2.  **Windowed update.**  Rays are <= 4.0 m = 40 cells, so all 32 rays of
    a scan live in an 89x89 window centered on the pose cell (41-cell
    radius after float rounding; we use 44 for margin).  The grid is kept
    physically padded to 608x640 so the (96, 128)-padded window can be
    read/written with one dynamic_slice each — never clamped, never OOB.

3.  **Closed-form Bresenham membership.**  The reference's err = dx+dy
    Bresenham visits exactly one cell per dominant-axis step, at the
    minor-axis offset  m(k) = (2*k*dmin + dmaj) // (2*dmaj).  (Derivation:
    the err update preserves err = dx+dy - 2*(k*dym - m*dx) ... verified
    exhaustively against the reference walk in tests.)  Membership of a
    window cell in a ray is therefore an equality test on iota grids —
    one vectorized compare instead of a sequential walk.

4.  **Exact sequential clamping.**  Cell updates saturate at +/-80 *per
    step*, so the 32-ray order (F0..F7,R0..R7,B0..B7,L0..L7) is observable
    when a cell is touched by several rays in one scan.  Per scan, a cell
    moves at most +48/-32, so at most ONE bound can engage; the clamped
    running sum then has the closed form (Skorokhod reflection)

        final = max(lo, min(mid, up))
        mid = v0 + S,  up = LO_MAX + S - maxP,  lo = LO_MIN + S - minP

    where S is the delta sum and maxP/minP the running prefix extrema over
    the ray axis.  One fori_loop over 32 rays carrying (P, maxP, minP)
    reproduces the sequential C semantics bit-for-bit with pure dense ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.utils.config import MapConfig, TofConfig

_F32 = np.float32
_DEG2RAD = _F32(np.pi) / _F32(180.0)


@dataclass(frozen=True)
class GridGeom:
    """Static padded-grid geometry derived from a MapConfig."""

    width: int = 500           # logical cells (x)
    height: int = 500          # logical cells (y)
    pad: int = 48              # logical origin offset inside padded array
    win_r: int = 44            # window radius in cells (>= max ray + rounding)
    win_rows: int = 96         # padded window rows (y), multiple of 8
    win_cols: int = 128        # padded window cols (x), multiple of 128
    prows: int = 608           # padded grid rows
    pcols: int = 640           # padded grid cols

    @classmethod
    def from_map(cls, cfg: MapConfig) -> "GridGeom":
        r = cfg.max_ray_cells + 4
        win_rows = -(-(2 * r + 1) // 8) * 8
        win_cols = -(-(2 * r + 1) // 128) * 128
        pad = r + 4
        prows = -(-(cfg.height + pad + (win_rows - r)) // 32) * 32
        pcols = -(-(cfg.width + pad + (win_cols - r)) // 128) * 128
        return cls(cfg.width, cfg.height, pad, r, win_rows, win_cols, prows, pcols)


DEFAULT_GEOM = GridGeom()


def new_padded_grid(geom: GridGeom = DEFAULT_GEOM, batch: tuple = ()) -> jnp.ndarray:
    return jnp.zeros(batch + (geom.prows, geom.pcols), jnp.int8)


def logical_grid(padded: jnp.ndarray, geom: GridGeom = DEFAULT_GEOM) -> jnp.ndarray:
    """Slice the logical HxW grid out of the padded array."""
    return padded[..., geom.pad: geom.pad + geom.height,
                  geom.pad: geom.pad + geom.width]


def world_to_cell(x, y, origin_x, origin_y, res: float,
                  half_w: int = 250, half_h: int = 250):
    """Cell indices with lrintf (round-half-even) semantics; the map origin
    sits at the grid center (uav_local_nav.c:205-214).  Returns (cx, cy)
    int32, unbounded."""
    res = _F32(res)
    cx = jnp.round((x - origin_x) / res).astype(jnp.int32) + half_w
    cy = jnp.round((y - origin_y) / res).astype(jnp.int32) + half_h
    return cx, cy


def make_rays(
    beams: jnp.ndarray,
    x_m: jnp.ndarray,
    y_m: jnp.ndarray,
    yaw_deg: jnp.ndarray,
    origin_x: jnp.ndarray,
    origin_y: jnp.ndarray,
    enabled,
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
):
    """Project one scan's beams [4, 8] to window-relative ray endpoints.

    Mirrors map_update_from_beams (uav_local_nav.c:280-306) in float32:
    skip NaN and <=0.05 m beams, hit iff dist < max_range-0.05, clamp to
    max_range, fan angle = yaw + dir_center + ((c-3.5)/3.5)*half_fov.

    Returns dict of [32] arrays (ray order F0..F7,R0..R7,B0..B7,L0..L7):
      ex, ey   int32 window-relative endpoint cells
      end_delta int32 endpoint log-odds delta (+occ_inc hit / -miss_dec)
      valid    bool
    plus scalar (pcx, pcy) pose cell (int32, clamped into the logical grid
    for safe slicing; rays are invalid when the true pose cell is OOB).
    """
    half_fov = _F32(tof.fov_deg) * _F32(0.5)
    cols = np.arange(8, dtype=np.float32)
    u = (cols - _F32(3.5)) / _F32(3.5)
    col_off = u * half_fov                               # f32 [8]
    centers = np.asarray(tof.dir_center_deg, np.float32)  # [4]

    dist = beams.reshape(4, 8)
    ray_ok = ~jnp.isnan(dist) & (dist > _F32(tof.map_skip_below_m))
    hit = dist < (_F32(tof.max_range_m) - _F32(tof.hit_margin_m))
    d = jnp.minimum(jnp.where(ray_ok, dist, _F32(0.0)), _F32(tof.max_range_m))

    ang_deg = (yaw_deg + centers[:, None]) + col_off[None, :]
    ang = ang_deg * _DEG2RAD
    ex_w = x_m + d * jnp.cos(ang)
    ey_w = y_m + d * jnp.sin(ang)

    pcx, pcy = world_to_cell(x_m, y_m, origin_x, origin_y, cfg.res_m,
                             cfg.width // 2, cfg.height // 2)
    ecx, ecy = world_to_cell(ex_w, ey_w, origin_x, origin_y, cfg.res_m,
                             cfg.width // 2, cfg.height // 2)

    pose_in = (pcx >= 0) & (pcx < cfg.width) & (pcy >= 0) & (pcy < cfg.height)
    end_in = (ecx >= 0) & (ecx < cfg.width) & (ecy >= 0) & (ecy < cfg.height)
    valid = ray_ok & end_in & pose_in & enabled

    pcx_safe = jnp.clip(pcx, 0, cfg.width - 1)
    pcy_safe = jnp.clip(pcy, 0, cfg.height - 1)

    ex = jnp.where(valid, ecx - pcx_safe, 0).reshape(32)
    ey = jnp.where(valid, ecy - pcy_safe, 0).reshape(32)
    end_delta = jnp.where(hit, cfg.lo_occ_inc, -cfg.lo_miss_end_dec).reshape(32)
    return {
        "ex": ex.astype(jnp.int32),
        "ey": ey.astype(jnp.int32),
        "end_delta": end_delta.astype(jnp.int32),
        "valid": valid.reshape(32),
        "pcx": pcx_safe,
        "pcy": pcy_safe,
    }


def window_scan_update(
    window: jnp.ndarray, rays: dict, cfg: MapConfig = MapConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> jnp.ndarray:
    """Apply one scan's 32 rays to the [win_rows, win_cols] int8 window
    centered at (win_r, win_r), with exact sequential-clamp semantics.

    The ray loop is PYTHON-UNROLLED (not fori_loop) so XLA fuses the whole
    224-op elementwise chain into a handful of kernels instead of
    materializing the (P, maxP, minP) carries in HBM 32 times; carries are
    int8 (per-scan range is [-32, +48]).  Per-ray full-window work is 6
    ops: two membership compares against sentinel-masked minor-offset
    vectors, a select, a broadcast endpoint test, the delta select, and
    the prefix updates."""
    R = geom.win_r
    rows = lax.broadcasted_iota(jnp.int32, (geom.win_rows, 1), 0) - R   # v (y)
    colr = lax.broadcasted_iota(jnp.int32, (1, geom.win_cols), 1) - R   # u (x)

    exs, eys = rays["ex"], rays["ey"]
    eds, vals = rays["end_delta"], rays["valid"]
    free_dec = jnp.int8(cfg.lo_free_dec)
    SENT = jnp.int32(127)  # impossible minor-offset: masks non-membership

    z8 = jnp.zeros((geom.win_rows, geom.win_cols), jnp.int8)
    P, mx, mn = z8, z8, z8
    for r in range(32):
        ex, ey, ed = exs[r], eys[r], eds[r].astype(jnp.int8)
        val = vals[r]
        dx, dy = jnp.abs(ex), jnp.abs(ey)
        sx = jnp.where(ex > 0, 1, -1)
        sy = jnp.where(ey > 0, 1, -1)
        kx = colr * sx            # [1, C]
        ky = rows * sy            # [R, 1]
        xmaj = dx >= dy
        # minor-axis offset along the dominant axis (closed-form Bresenham),
        # sentinel-masked outside the ray extent / when the ray is invalid
        # or the other axis is dominant -> membership is ONE compare each.
        mX = (2 * kx * dy + dx) // jnp.maximum(2 * dx, 1)   # [1, C]
        mY = (2 * ky * dx + dy) // jnp.maximum(2 * dy, 1)   # [R, 1]
        okX = (kx >= 0) & (kx <= dx) & xmaj & val
        okY = (ky >= 0) & (ky <= dy) & (~xmaj) & val
        mX = jnp.where(okX, mX, SENT)
        mY = jnp.where(okY, mY, SENT)
        member = (ky == mX) | (kx == mY)                    # [R, C]
        is_end = (colr == ex) & (rows == ey)                # [R, C] broadcast
        delta = jnp.where(member, jnp.where(is_end, ed, -free_dec),
                          jnp.int8(0))
        P = P + delta
        mx = jnp.maximum(mx, P)
        mn = jnp.minimum(mn, P)

    v0 = window.astype(jnp.int16)
    P16, mx16, mn16 = (a.astype(jnp.int16) for a in (P, mx, mn))
    mid = v0 + P16
    up = jnp.int16(cfg.lo_max) + P16 - mx16
    lo = jnp.int16(cfg.lo_min) + P16 - mn16
    return jnp.maximum(jnp.minimum(mid, up), lo).astype(jnp.int8)


def apply_scan_to_grid(
    padded_grid: jnp.ndarray,
    beams: jnp.ndarray,
    x_m, y_m, yaw_deg,
    origin_x, origin_y,
    enabled,
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> jnp.ndarray:
    """One fused scan update: beams -> rays -> window read-modify-write."""
    rays = make_rays(beams, x_m, y_m, yaw_deg, origin_x, origin_y,
                     enabled, cfg, tof)
    r0 = rays["pcy"] + geom.pad - geom.win_r
    c0 = rays["pcx"] + geom.pad - geom.win_r
    win = lax.dynamic_slice(padded_grid, (r0, c0),
                            (geom.win_rows, geom.win_cols))
    win = window_scan_update(win, rays, cfg, geom)
    return lax.dynamic_update_slice(padded_grid, win, (r0, c0))


def recenter_decide(
    origin_x, origin_y, x_m, y_m, pose_ok, cfg: MapConfig = MapConfig(),
):
    """Cheap scalar part of map recentering (uav_local_nav.c:324-343):
    shift cells (sx, sy) clamped to +/-recenter_max_shift_cells, and the
    `do` flag.  Zero shift when not recentering."""
    half = _F32(cfg.size_m) * _F32(0.5)
    thresh = half * _F32(cfg.recenter_frac)
    dx = x_m - origin_x
    dy = y_m - origin_y
    need = pose_ok & ((jnp.abs(dx) >= thresh) | (jnp.abs(dy) >= thresh))

    res = _F32(cfg.res_m)
    mx = cfg.recenter_max_shift_cells
    sx = jnp.clip(jnp.round(dx / res).astype(jnp.int32), -mx, mx)
    sy = jnp.clip(jnp.round(dy / res).astype(jnp.int32), -mx, mx)
    do = need & ((sx != 0) | (sy != 0))
    return jnp.where(do, sx, 0), jnp.where(do, sy, 0), do


def shift_origin(origin, s_cells, res):
    """origin + s_cells * res with the product pinned to its own f32
    rounding step: a bare mul+add gets fma-contracted by the backend in
    some fusion contexts (observed when a consumer scan was unrolled) and
    the 1-ULP skew breaks cross-kernel bit-equality of the origins.  The
    select is value-identity (origin is NaN only before map init, where
    NaN + anything = NaN anyway) but blocks the contraction pattern."""
    prod = jnp.where(origin == origin, s_cells.astype(jnp.float32) * res,
                     origin)
    return origin + prod


def recenter_apply(
    padded_grid: jnp.ndarray, sx, sy,
    cfg: MapConfig = MapConfig(), geom: GridGeom = DEFAULT_GEOM,
) -> jnp.ndarray:
    """Expensive part: whole-cell grid shift new[y, x] = old[y+sy, x+sx]
    (uav_local_nav.c:308-322), zero where the source falls outside the
    logical region; margins stay zero.  (sx, sy) == (0, 0) is an exact
    no-op.  Callers should branch around this with a batch-level lax.cond
    — recentering is rare, and this touches the full grid."""
    rolled = jnp.roll(jnp.roll(padded_grid, -sy, axis=-2), -sx, axis=-1)
    r_ids = lax.broadcasted_iota(jnp.int32, (geom.prows, 1), 0)
    c_ids = lax.broadcasted_iota(jnp.int32, (1, geom.pcols), 1)
    in_log = (
        (r_ids >= geom.pad) & (r_ids < geom.pad + geom.height)
        & (c_ids >= geom.pad) & (c_ids < geom.pad + geom.width)
    )
    src_in = (
        (r_ids + sy >= geom.pad) & (r_ids + sy < geom.pad + geom.height)
        & (c_ids + sx >= geom.pad) & (c_ids + sx < geom.pad + geom.width)
    )
    return jnp.where(in_log & src_in, rolled, jnp.int8(0))


def recenter_grid(
    padded_grid: jnp.ndarray,
    origin_x, origin_y,
    x_m, y_m,
    pose_ok,
    cfg: MapConfig = MapConfig(),
    geom: GridGeom = DEFAULT_GEOM,
):
    """Conditional whole-cell grid shift (uav_local_nav.c:324-353).
    Convenience single-quad wrapper over recenter_decide/recenter_apply.
    Returns (grid, origin_x, origin_y, recentered_flag)."""
    sx, sy, do = recenter_decide(origin_x, origin_y, x_m, y_m, pose_ok, cfg)
    shifted = recenter_apply(padded_grid, sx, sy, cfg, geom)
    grid = jnp.where(do, shifted, padded_grid)
    res = _F32(cfg.res_m)
    origin_x = jnp.where(do, origin_x + sx.astype(jnp.float32) * res, origin_x)
    origin_y = jnp.where(do, origin_y + sy.astype(jnp.float32) * res, origin_y)
    return grid, origin_x, origin_y, do


def _frontier_step_dists(cfg: MapConfig) -> np.ndarray:
    """Reproduce the C loop `for (d = step; d <= max_range; d += step)` with
    float32 accumulation — the step count is float-sensitive
    (uav_local_nav.c:370)."""
    step = _F32(cfg.res_m) * _F32(cfg.frontier_step_cells)
    out = []
    d = step
    while d <= _F32(cfg.frontier_range_m):
        out.append(d)
        d = _F32(d + step)
    return np.asarray(out, np.float32)


def frontier_scores(
    padded_grid: jnp.ndarray,
    x_m, y_m, yaw_deg,
    offsets_deg,
    origin_x, origin_y,
    inited,
    cfg: MapConfig = MapConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> jnp.ndarray:
    """Vectorized frontier_score_dir (uav_local_nav.c:356-385) for several
    query directions at once.

    offsets_deg: static tuple/array of D query offsets (e.g. (0, 90, -90,
    180)).  Returns int32 [D] scores.  A ray stepping out of the logical
    grid stops contributing from that step on (lines are monotone, so the
    C `break` equals masking all OOB steps).
    """
    offs = np.asarray(offsets_deg, np.float32)             # [D]
    rays = np.asarray(cfg.frontier_ray_offsets_deg, np.float32)  # [3]
    dists = _frontier_step_dists(cfg)                      # [S]

    ang = ((yaw_deg + offs[:, None]) + rays[None, :]) * _DEG2RAD  # [D, 3]
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    px = x_m + dists[None, None, :] * ca[..., None]        # [D, 3, S]
    py = y_m + dists[None, None, :] * sa[..., None]
    cx, cy = world_to_cell(px, py, origin_x, origin_y, cfg.res_m,
                           cfg.width // 2, cfg.height // 2)
    inb = (cx >= 0) & (cx < cfg.width) & (cy >= 0) & (cy < cfg.height)
    cxs = jnp.clip(cx, 0, cfg.width - 1) + geom.pad
    cys = jnp.clip(cy, 0, cfg.height - 1) + geom.pad
    v = padded_grid[cys, cxs].astype(jnp.int32)            # gather [D, 3, S]
    m = inb & inited
    unknown = (m & (v >= -cfg.frontier_unknown_band)
               & (v <= cfg.frontier_unknown_band)).sum(axis=(-1, -2))
    occ = (m & (v > cfg.frontier_occ_thresh)).sum(axis=(-1, -2))
    free = (m & (v < cfg.frontier_free_thresh)).sum(axis=(-1, -2))
    return (unknown * cfg.frontier_w_unknown + free * cfg.frontier_w_free
            - occ * cfg.frontier_w_occ).astype(jnp.int32)


def apply_scan_to_grid_mxu(
    padded_grid: jnp.ndarray,    # i8 [B, prows, pcols]
    beams: jnp.ndarray,          # f32 [B, 4, 8]
    x_m, y_m, yaw_deg,           # f32 [B]
    origin_x, origin_y,          # f32 [B]
    enabled,                     # bool [B]
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> jnp.ndarray:
    """Batched fused scan update with matmul-based window IO.

    XLA lowers a batched dynamic_slice of per-quad (96, 128) sub-row
    windows to a strided gather.  This variant reads a CONTIGUOUS
    full-row slab (96, pcols) per quad (row-major int8: one 61 KB block,
    cheap even as a gather), then selects/merges the 128 window columns
    with one-hot bf16 matmuls, turning data movement into matmul work
    (one-hot products are exact for the int8 value range).  Results are
    bit-identical to vmap(apply_scan_to_grid).
    """
    import jax as _jax

    B = padded_grid.shape[0]
    WR, WC, PC = geom.win_rows, geom.win_cols, geom.pcols

    rays = _jax.vmap(
        lambda b_, x_, y_, w_, ox_, oy_, en_: make_rays(
            b_, x_, y_, w_, ox_, oy_, en_, cfg, tof)
    )(beams, x_m, y_m, yaw_deg, origin_x, origin_y, enabled)
    r0 = rays["pcy"] + geom.pad - geom.win_r          # [B]
    c0 = rays["pcx"] + geom.pad - geom.win_r

    # contiguous row-slab read: [B, WR, PC]
    slab = _jax.vmap(
        lambda g, r: lax.dynamic_slice(g, (r, jnp.int32(0)), (WR, PC))
    )(padded_grid, r0)

    # one-hot column selector [B, PC, WC] (bf16: int8 range is exact)
    pcols_iota = lax.broadcasted_iota(jnp.int32, (1, PC, 1), 1)
    wcols_iota = lax.broadcasted_iota(jnp.int32, (1, 1, WC), 2)
    Cx = (pcols_iota == (c0[:, None, None] + wcols_iota)).astype(jnp.bfloat16)

    win = jnp.einsum("brc,bck->brk", slab.astype(jnp.bfloat16), Cx,
                     preferred_element_type=jnp.float32)
    win = jnp.round(win).astype(jnp.int8)

    win_new = _jax.vmap(
        lambda w, e, ey, ed, v: window_scan_update(
            w, {"ex": e, "ey": ey, "end_delta": ed, "valid": v,
                "pcx": jnp.int32(0), "pcy": jnp.int32(0)}, cfg, geom)
    )(win, rays["ex"], rays["ey"], rays["end_delta"], rays["valid"])

    delta = (win_new.astype(jnp.int16) - win.astype(jnp.int16))
    slab_delta = jnp.einsum("brk,bck->brc", delta.astype(jnp.bfloat16), Cx,
                            preferred_element_type=jnp.float32)
    slab_new = (slab.astype(jnp.int16)
                + jnp.round(slab_delta).astype(jnp.int16)).astype(jnp.int8)

    return _jax.vmap(
        lambda g, s, r: lax.dynamic_update_slice(g, s, (r, jnp.int32(0)))
    )(padded_grid, slab_new, r0)


def apply_scan_to_grid_mxu2(
    padded_grid_bf16: jnp.ndarray,   # bf16 [B, prows, pcols] (int8 values)
    beams: jnp.ndarray,              # f32 [B, 4, 8]
    x_m, y_m, yaw_deg,               # f32 [B]
    origin_x, origin_y,              # f32 [B]
    enabled,                         # bool [B]
    cfg: MapConfig = MapConfig(),
    tof: TofConfig = TofConfig(),
    geom: GridGeom = DEFAULT_GEOM,
) -> jnp.ndarray:
    """Gather-free fused scan update: BOTH window axes are selected and
    merged with one-hot bfloat16 matmuls.

    Per-quad dynamic windows lower to batched gathers/scatters, so this
    variant keeps the occupancy grid in bfloat16 (int8 log-odds values
    are exact in bf16) and expresses window read as
    W = Ry @ G @ Cx and write-back as G += Ry^T @ dW @ Cx^T — pure batched
    matmuls with no data-dependent memory ops anywhere.  Bit-identical
    values to the XLA path (compare after int8 cast).
    """
    import jax as _jax

    B = padded_grid_bf16.shape[0]
    WR, WC = geom.win_rows, geom.win_cols
    PR, PC = geom.prows, geom.pcols

    rays = _jax.vmap(
        lambda b_, x_, y_, w_, ox_, oy_, en_: make_rays(
            b_, x_, y_, w_, ox_, oy_, en_, cfg, tof)
    )(beams, x_m, y_m, yaw_deg, origin_x, origin_y, enabled)
    r0 = rays["pcy"] + geom.pad - geom.win_r
    c0 = rays["pcx"] + geom.pad - geom.win_r

    # one-hot selectors (bf16 exact)
    pr_i = lax.broadcasted_iota(jnp.int32, (1, WR, PR), 2)
    wr_i = lax.broadcasted_iota(jnp.int32, (1, WR, PR), 1)
    Ry = (pr_i == (r0[:, None, None] + wr_i)).astype(jnp.bfloat16)  # [B,WR,PR]
    pc_i = lax.broadcasted_iota(jnp.int32, (1, PC, 1), 1)
    wc_i = lax.broadcasted_iota(jnp.int32, (1, 1, WC), 2)
    Cx = (pc_i == (c0[:, None, None] + wc_i)).astype(jnp.bfloat16)  # [B,PC,WC]

    slab = jnp.einsum("brp,bpc->brc", Ry, padded_grid_bf16,
                      preferred_element_type=jnp.float32)
    win = jnp.einsum("brc,bck->brk", slab.astype(jnp.bfloat16), Cx,
                     preferred_element_type=jnp.float32)
    win8 = jnp.round(win).astype(jnp.int8)

    win_new = _jax.vmap(
        lambda w, e, ey, ed, v: window_scan_update(
            w, {"ex": e, "ey": ey, "end_delta": ed, "valid": v,
                "pcx": jnp.int32(0), "pcy": jnp.int32(0)}, cfg, geom)
    )(win8, rays["ex"], rays["ey"], rays["end_delta"], rays["valid"])

    delta = (win_new.astype(jnp.int16) - win8.astype(jnp.int16)).astype(jnp.bfloat16)
    dslab = jnp.einsum("brk,bck->brc", delta, Cx,
                       preferred_element_type=jnp.float32)
    dgrid = jnp.einsum("brp,brc->bpc", Ry, dslab.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    return (padded_grid_bf16 + dgrid.astype(jnp.bfloat16)).astype(jnp.bfloat16)
