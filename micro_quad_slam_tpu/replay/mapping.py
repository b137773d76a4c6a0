"""Mapping replay engine: scanlog stream -> occupancy grid, on device.

This is the minimum end-to-end slice of the framework (SURVEY.md §7 step 4):
the reference's offline-mapping pipeline (scan ingestion call stack, SURVEY
§3.2) recomputed from logged poses as one pure step function.

Structure: ONE `lax.scan` over time with the whole batch inside
each step (not vmap-of-scan).  This (a) amortizes per-step dispatch over
all B quads, and (b) lets the rare full-grid recenter hide behind a
batch-level `lax.cond` — under vmap-of-scan the cond would decay to a
select that pays the full-grid shift every frame for every quad; with the
batch inside the step the predicate `any(do)` is a true scalar and XLA
emits a real branch, so the common path never touches whole grids.

Replay policy (identical to golden_replay_mapping so the two bit-match;
see micro_quad_slam_tpu/golden/model.py for the scanrec-field proxies):

  * map init at the first record with finite (x, y) and an airborne state
    (HOVER..LANDING; the reference inits at hover XY lock,
    uav_local_nav.c:2187-2194); origin = that record's pose; the init
    frame itself is mapped.
  * per record: recenter-if-needed when (x, y) finite
    (uav_local_nav.c:1629-1631), then update iff pose_good_for_mapping
    (uav_local_nav.c:1633-1635, :935-947).
  * ToF EMA filter state advances every record (uav_local_nav.c:1430-1438).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.ops.beams import extract_beams, tof_filter_update
from micro_quad_slam_tpu.ops.conemode import cone_scan_update, hybrid_scan_update
from micro_quad_slam_tpu.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_scan_to_grid,
    apply_scan_to_grid_mxu,
    apply_scan_to_grid_mxu2,
    recenter_apply,
    recenter_decide,
    shift_origin,
)
from micro_quad_slam_tpu.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32

# Map-update kernels by name.  "xla", "mxu" and "mxu2" are bit-exact
# reference semantics; "cone" is the dense inverse-sensor-model mode and
# "hybrid" the production mode (dense free carve + the reference's exact
# endpoint occupied semantics).  Per-quad updates are vmapped over the
# batch; the mxu variants take the whole batch.
_VMAPPED_UPDATES = {"xla": apply_scan_to_grid, "cone": cone_scan_update,
                    "hybrid": hybrid_scan_update}
_BATCHED_UPDATES = {"mxu": apply_scan_to_grid_mxu,
                    "mxu2": apply_scan_to_grid_mxu2}
KERNELS = tuple(_VMAPPED_UPDATES) + tuple(_BATCHED_UPDATES)

# MAV_SYS_STATUS sensor bits (MAVLink common enum values)
SENSOR_3D_GYRO = 0x01
SENSOR_Z_ALTITUDE_CONTROL = 0x2000
SENSOR_XY_POSITION_CONTROL = 0x4000
SENSOR_MOTOR_OUTPUTS = 0x400000

# Behavior states with the map active (uav_local_nav.c:484-496)
ST_HOVER, ST_LANDING = 5, 8

# Keyframe flag bit for recentering (uav_local_nav.c:225)
KF_MAP_RECENTER = 1 << 5


class MappingState(NamedTuple):
    """Per-quad mapper state; every field carries a leading batch dim [B]
    (B == () for the single-flight wrappers)."""

    grid: jnp.ndarray       # int8 [B, prows, pcols] padded occupancy grid
    origin_x: jnp.ndarray   # f32 [B] map origin (world NED at grid center)
    origin_y: jnp.ndarray
    inited: jnp.ndarray     # bool [B]
    filt: jnp.ndarray       # f32 [B, 4] EMA'd per-direction ToF minima


def mapping_init(batch: int = 1, geom: GridGeom = DEFAULT_GEOM) -> MappingState:
    return MappingState(
        grid=jnp.zeros((batch, geom.prows, geom.pcols), jnp.int8),
        origin_x=jnp.full((batch,), jnp.nan, jnp.float32),
        origin_y=jnp.full((batch,), jnp.nan, jnp.float32),
        inited=jnp.zeros((batch,), bool),
        filt=jnp.full((batch, 4), jnp.nan, jnp.float32),
    )


def _sys_bit_ok(sys_health, bit):
    """sys_health == 0 means 'no SYS_STATUS recorded' => healthy (the
    scanrec writer stores 0 then, uav_local_nav.c:1576; matches the
    reference's stale-SYS fallback, :904-907)."""
    return (sys_health == 0) | ((sys_health & bit) != 0)


def pose_good_for_mapping(x_m, yaw_deg, of_q, of_rate_x, sys_health,
                          of_min_quality: int):
    """Replay-time pose_good_for_mapping (uav_local_nav.c:935-947):
    lpos-fresh <=> x finite, have_att <=> yaw finite, XY/Z health from the
    recorded bits, flow-fresh <=> recorded rate finite."""
    ok = jnp.isfinite(x_m) & jnp.isfinite(yaw_deg)
    ok &= _sys_bit_ok(sys_health, SENSOR_XY_POSITION_CONTROL)
    ok &= _sys_bit_ok(sys_health, SENSOR_Z_ALTITUDE_CONTROL)
    of_fresh = jnp.isfinite(of_rate_x)
    ok &= (~of_fresh) | (of_q >= of_min_quality)
    return ok


def mapping_step(
    state: MappingState,
    frame: dict,
    cfg: PipelineConfig = UL_PROFILE,
    geom: GridGeom = DEFAULT_GEOM,
    kernel: str = "xla",
):
    """One scanrec (for the whole [B] batch) through the mapper.

    `frame` holds [B]-leading arrays: either raw `grid_mm` u16 [B,4,8,8]
    or precomputed `beams`/`minima` (the replay driver extracts beams for
    all frames up-front — embarrassingly parallel, outside the scan).
    `kernel` is one of KERNELS; any other name raises ValueError.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown map-update kernel {kernel!r}; "
                         f"expected one of {KERNELS}")
    if "beams" in frame:
        beams, minima = frame["beams"], frame["minima"]
    else:
        beams, minima = extract_beams(frame["grid_mm"], cfg.tof)

    filt = tof_filter_update(state.filt, minima, cfg.tof.filt_alpha)

    x, y, yaw = frame["x_m"], frame["y_m"], frame["yaw_deg"]
    pose_finite = jnp.isfinite(x) & jnp.isfinite(y)

    # map init at first airborne record with a finite pose.  The state
    # byte uses the writing binary's enum: UL has HOVER..LANDING = 5..8
    # (uav_local_nav.c:484-496); CL (no EXPLORE/TURNING) has
    # HOVER, LANDING = 5, 6 (clean:325-335).
    st = frame["state"].astype(jnp.int32)
    st_hi = ST_LANDING if cfg.behavior.explore_enabled else 6
    airborne = (st >= ST_HOVER) & (st <= st_hi)
    do_init = (~state.inited) & pose_finite & airborne
    origin_x = jnp.where(do_init, x, state.origin_x)
    origin_y = jnp.where(do_init, y, state.origin_y)
    inited = state.inited | do_init

    # recenter (uav_local_nav.c:1629-1631): cheap per-quad decision, full
    # grid shift only behind a real branch when ANY quad needs it.
    sx, sy, do_rc = recenter_decide(
        origin_x, origin_y, x, y, pose_finite & inited, cfg.map
    )
    grid = lax.cond(
        do_rc.any(),
        lambda g: jax.vmap(
            lambda gi, sxi, syi: recenter_apply(gi, sxi, syi, cfg.map, geom)
        )(g, sx, sy),
        lambda g: g,
        state.grid,
    )
    res = _F32(cfg.map.res_m)
    origin_x = shift_origin(origin_x, sx, res)
    origin_y = shift_origin(origin_y, sy, res)

    enabled = inited & pose_good_for_mapping(
        x, yaw, frame["of_q"].astype(jnp.int32), frame["of_rate_x"],
        frame["sys_health"], cfg.gates.of_min_quality,
    )
    args = (beams, x, y, yaw, origin_x, origin_y, enabled, cfg.map, cfg.tof,
            geom)
    if kernel in _BATCHED_UPDATES:
        grid = _BATCHED_UPDATES[kernel](grid, *args)
    else:
        update = _VMAPPED_UPDATES[kernel]
        grid = jax.vmap(
            lambda gi, b, xi, yi, yawi, oxi, oyi, en: update(
                gi, b, xi, yi, yawi, oxi, oyi, en, cfg.map, cfg.tof, geom)
        )(grid, *args[:7])

    new_state = MappingState(grid, origin_x, origin_y, inited, filt)
    out = {
        "used": enabled,
        "kf_flags": jnp.where(do_rc, jnp.uint8(KF_MAP_RECENTER),
                              jnp.uint8(0)),
        "filt": filt,
    }
    return new_state, out


def scanlog_to_arrays(scanlog) -> dict:
    """Host-side: ScanLog -> dict of [T] device-ready numpy arrays."""
    return {
        "grid_mm": np.ascontiguousarray(scanlog.grid_mm),
        "x_m": np.ascontiguousarray(scanlog.x_m),
        "y_m": np.ascontiguousarray(scanlog.y_m),
        "yaw_deg": np.ascontiguousarray(scanlog.yaw_deg),
        "of_q": np.ascontiguousarray(scanlog.of_q),
        "of_rate_x": np.ascontiguousarray(scanlog.of_rate_x),
        "sys_health": np.ascontiguousarray(scanlog.sys_health),
        "state": np.ascontiguousarray(scanlog.state),
    }


_SEQ_KEYS = ("x_m", "y_m", "yaw_deg", "of_q", "of_rate_x", "sys_health", "state")


def _replay_batched(frames: dict, cfg: PipelineConfig, geom: GridGeom,
                    kernel: str = "xla", state0=None):
    """frames: dict of [B, T, ...] arrays -> (MappingState [B], outs [B, T]).

    state0 resumes a previous replay (checkpoint-restart, SURVEY.md §5.4):
    pass the MappingState from an earlier call (possibly round-tripped
    through utils/checkpoint) and the continuation is bit-identical to
    replaying the concatenated frames in one call."""
    if state0 is not None and \
            state0.origin_x.shape[0] != frames["x_m"].shape[0]:
        raise ValueError(
            f"batch mismatch: state0 holds {state0.origin_x.shape[0]} "
            f"flights but frames hold {frames['x_m'].shape[0]} (resume "
            f"must continue the same batch)")
    B, T = frames["x_m"].shape
    # beams for every (flight, frame) at once — parallel, outside the scan
    beams, minima = extract_beams(frames["grid_mm"], cfg.tof)
    seq = {k: jnp.moveaxis(frames[k], 0, 1) for k in _SEQ_KEYS}  # [T, B, ...]
    seq["beams"] = jnp.moveaxis(beams, 0, 1)
    seq["minima"] = jnp.moveaxis(minima, 0, 1)

    init = state0 if state0 is not None else mapping_init(B, geom)
    if kernel == "mxu2":
        # the mxu2 kernel carries the grid in bf16 (int8 values exact)
        init = init._replace(grid=init.grid.astype(jnp.bfloat16))

    def step(st, fr):
        return mapping_step(st, fr, cfg, geom, kernel)

    state, outs = lax.scan(step, init, seq)
    if kernel == "mxu2":
        state = state._replace(grid=jnp.round(state.grid).astype(jnp.int8))
    outs = {k: jnp.moveaxis(v, 0, 1) for k, v in outs.items()}  # [B, T, ...]
    return state, outs


@partial(jax.jit, static_argnums=(1, 2, 3))
def replay_mapping_batched(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                           geom: GridGeom = DEFAULT_GEOM,
                           kernel: str = "xla", state0=None):
    """Batched replay: frames dict of [B, T, ...] arrays.  kernel (one of
    KERNELS, else ValueError): "xla" / "mxu" / "mxu2" are bit-exact
    reference semantics; "cone" is the dense inverse-sensor-model mode
    and "hybrid" the production mode (dense free-space carve + the
    reference's exact endpoint occupied semantics); neither is bit-exact
    vs the reference.

    state0: resume from a prior replay's MappingState (checkpoint-
    restart); the continuation bit-matches an unbroken replay."""
    return _replay_batched(frames, cfg, geom, kernel, state0)


@partial(jax.jit, static_argnums=(1, 2))
def replay_mapping(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                   geom: GridGeom = DEFAULT_GEOM):
    """Replay one flight: frames dict of [T, ...] arrays.

    Returns (MappingState without the batch dim, outs of [T, ...]).
    jit-compiled with the config static; reuse the same cfg object to hit
    the compile cache.
    """
    frames_b = {k: v[None] for k, v in frames.items()}
    state, outs = _replay_batched(frames_b, cfg, geom)
    state = MappingState(*(v[0] for v in state))
    outs = {k: v[0] for k, v in outs.items()}
    return state, outs
