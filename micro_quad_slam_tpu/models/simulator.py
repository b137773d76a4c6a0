"""Closed-loop swarm simulator: N virtual quads flying the full autonomy
stack on-device (BASELINE.json config 5: 1024 quads, online mapping +
fusion at 1 kHz on one chip).

Each sim step composes the whole framework:

  world raytrace -> ToF scan synth (A3-A5 analog)     [10 Hz, batch-cond]
  FC model       -> telemetry (L0/L1 analog)          [every step]
  EKF            -> pose estimate (ops/ekf.py)        [flow rate]
  mapper         -> occupancy grid (ops/raycast.py)   [scan ticks]
  frontier       -> exploration queries (B7)          [scan ticks]
  behavior       -> commands (models/behavior.py)     [every step]
  dynamics       -> pose/velocity integration         [every step]

The reference ran this loop across four processors at 10-50 Hz
(SURVEY.md §1); here it is one pure jittable function, vmapped over the
swarm, with the expensive scan-tick work (ray-cast grid update) behind a
batch-level lax.cond so the 1 kHz ticks between scans stay cheap.

The FC model mirrors ArduPilot's observable behavior at the level the
companion code depends on (SURVEY.md §2C): arming via command, GUIDED
NAV_TAKEOFF climb, LAND descent, velocity/position setpoint response,
motor spool telemetry, landed-state detection.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.models.behavior import (
    CMD_POS_YAW,
    CMD_VEL_BODY,
    CMD_VEL_NED,
    MODE_LAND,
    BehaviorState,
    behavior_init,
    behavior_step,
)
from micro_quad_slam_tpu.ops.beams import extract_beams
from micro_quad_slam_tpu.ops.ekf import EkfState, ekf_init, ekf_step
from micro_quad_slam_tpu.ops.raycast import (
    DEFAULT_GEOM,
    GridGeom,
    apply_scan_to_grid,
    frontier_scores,
)
from micro_quad_slam_tpu.replay.mapping import MappingState, mapping_init
from micro_quad_slam_tpu.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32
HEALTH_ALL = 0x01 | 0x2000 | 0x4000 | 0x400000


class World(NamedTuple):
    """Axis-aligned rooms with rectangular obstacles, per quad.

    room: f32 [B, 4] (xmin, ymin, xmax, ymax)
    obstacles: f32 [B, K, 4]; obstacle_mask: bool [B, K]
    """

    room: jnp.ndarray
    obstacles: jnp.ndarray
    obstacle_mask: jnp.ndarray


def make_world(batch: int, room=(-4.0, -4.0, 4.0, 4.0), obstacles=(),
               max_obstacles: int = 4) -> World:
    K = max(max_obstacles, len(obstacles))
    obs = np.zeros((batch, K, 4), np.float32)
    msk = np.zeros((batch, K), bool)
    for i, ob in enumerate(obstacles):
        obs[:, i] = ob
        msk[:, i] = True
    return World(
        room=jnp.broadcast_to(jnp.asarray(room, jnp.float32), (batch, 4)),
        obstacles=jnp.asarray(obs),
        obstacle_mask=jnp.asarray(msk),
    )


def ray_distances(world: World, x, y, ang_rad):
    """Exact distance to the nearest wall along angles [B, R] from inside
    the room (vectorized twin of sim/synthio.room_tof_distance)."""
    c = jnp.cos(ang_rad)
    s = jnp.sin(ang_rad)
    big = _F32(1e9)
    eps = _F32(1e-12)

    def exit_dist(lo, hi, o, d):
        t_hi = jnp.where(d > eps, (hi - o) / d, big)
        t_lo = jnp.where(d < -eps, (lo - o) / d, big)
        return jnp.minimum(jnp.where(t_hi > 0, t_hi, big),
                           jnp.where(t_lo > 0, t_lo, big))

    rx0, ry0, rx1, ry1 = (world.room[..., i, None] for i in range(4))
    d_room = jnp.minimum(exit_dist(rx0, rx1, x[..., None], c),
                         exit_dist(ry0, ry1, y[..., None], s))

    def enter_dist(b):
        """[B, K, R] entry distance into obstacle boxes from outside."""
        bx0, by0, bx1, by1 = (world.obstacles[..., i, None] for i in range(4))
        cc = c[..., None, :]
        ss = s[..., None, :]
        ox = x[..., None, None]
        oy = y[..., None, None]

        def axis(lo, hi, o, d):
            t0 = (lo - o) / jnp.where(jnp.abs(d) < eps, eps, d)
            t1 = (hi - o) / jnp.where(jnp.abs(d) < eps, eps, d)
            tmin = jnp.minimum(t0, t1)
            tmax = jnp.maximum(t0, t1)
            par = jnp.abs(d) < eps
            inside = (o >= lo) & (o <= hi)
            tmin = jnp.where(par, jnp.where(inside, -big, big), tmin)
            tmax = jnp.where(par, jnp.where(inside, big, -big), tmax)
            return tmin, tmax

        txm, txM = axis(bx0, bx1, ox, cc)
        tym, tyM = axis(by0, by1, oy, ss)
        tmin = jnp.maximum(jnp.maximum(txm, tym), 0.0)
        tmax = jnp.minimum(txM, tyM)
        hit = (tmin <= tmax) & (tmin > 0) & world.obstacle_mask[..., None]
        return jnp.where(hit, tmin, big).min(axis=-2)

    return jnp.minimum(d_room, enter_dist(world))


def synth_scan_mm(world: World, x, y, yaw_deg, key, noise_mm: float,
                  dropout_p: float, cfg: PipelineConfig):
    """Synthesize a [B, 4, 8, 8] u16 ToF grid from the world (hub analog,
    tof_esp32.ino:183-209): all 8 rows of a column see the column's fan
    distance, plus noise/dropout to exercise the second-min beam logic."""
    tof = cfg.tof
    half_fov = _F32(tof.half_fov_deg)
    u = (jnp.arange(8, dtype=jnp.float32) - _F32(3.5)) / _F32(3.5)
    centers = jnp.asarray(tof.dir_center_deg, jnp.float32)
    ang_deg = yaw_deg[..., None] + (centers[:, None] + u[None, :] * half_fov).reshape(-1)
    ang = ang_deg * _F32(np.pi / 180.0)
    dist = ray_distances(world, x, y, ang)           # [B, 32]
    mm = dist.reshape(dist.shape[:-1] + (4, 1, 8)) * _F32(1000.0)
    mm = jnp.broadcast_to(mm, mm.shape[:-3] + (4, 8, 8))
    k1, k2 = jax.random.split(key)
    if noise_mm > 0:
        mm = mm + jax.random.normal(k1, mm.shape, jnp.float32) * _F32(noise_mm)
    cells = jnp.clip(jnp.round(mm), 1, 65000).astype(jnp.uint16)
    cells = jnp.where(mm > 60000.0, jnp.uint16(0xFFFF), cells)
    if dropout_p > 0:
        drop = jax.random.uniform(k2, cells.shape) < dropout_p
        cells = jnp.where(drop, jnp.uint16(0xFFFF), cells)
    return cells


class FcSim(NamedTuple):
    """Observable flight-controller model state (per quad)."""

    armed: jnp.ndarray
    mode: jnp.ndarray
    motor: jnp.ndarray
    takeoff_active: jnp.ndarray
    takeoff_target: jnp.ndarray
    have_ack: jnp.ndarray
    ack_res: jnp.ndarray
    ack_ms: jnp.ndarray
    accept_ms: jnp.ndarray
    batt_v: jnp.ndarray
    climb_cmd: jnp.ndarray      # +up, from CMD_VEL_NED
    vset_bx: jnp.ndarray        # body-frame velocity setpoint
    vset_by: jnp.ndarray
    yaw_rate_cmd: jnp.ndarray   # deg/s
    pos_cmd: jnp.ndarray        # [B, 3] x, y, z_down from CMD_POS_YAW
    pos_cmd_yaw: jnp.ndarray
    pos_hold: jnp.ndarray       # bool: position setpoint active


def fc_init(batch: int, batt_v0: float = 8.2) -> FcSim:
    z = lambda dt=jnp.float32: jnp.zeros((batch,), dt)
    return FcSim(
        armed=z(bool), mode=z(jnp.int32), motor=jnp.full((batch,), 1000.0, jnp.float32),
        takeoff_active=z(bool), takeoff_target=z(), have_ack=z(bool),
        ack_res=z(jnp.int32), ack_ms=z(jnp.int32), accept_ms=z(jnp.int32),
        batt_v=jnp.full((batch,), batt_v0, jnp.float32),
        climb_cmd=z(), vset_bx=z(), vset_by=z(), yaw_rate_cmd=z(),
        pos_cmd=jnp.zeros((batch, 3), jnp.float32), pos_cmd_yaw=z(),
        pos_hold=z(bool),
    )


CAM_SIZE = 32       # downward camera resolution (vision-flow mode)
CAM_FOCAL = 60.0    # focal length in pixels


class SimState(NamedTuple):
    t_ms: jnp.ndarray           # scalar int32
    key: jnp.ndarray
    x: jnp.ndarray              # true pose [B]
    y: jnp.ndarray
    yaw: jnp.ndarray            # deg, wrapped
    vx: jnp.ndarray             # true world velocity
    vy: jnp.ndarray
    alt: jnp.ndarray
    fc: FcSim
    beh: BehaviorState
    mapper: MappingState
    ekf: EkfState
    tof_min: jnp.ndarray        # [B, 4] latest per-dir minima
    scan_count: jnp.ndarray     # scalar int32
    cam_prev: jnp.ndarray       # [B, CAM, CAM] previous camera frame
    cam_valid: jnp.ndarray      # scalar bool: cam_prev holds a real frame
    vis_rate_x: jnp.ndarray     # [B] latched vision flow rates (rad/s)
    vis_rate_y: jnp.ndarray
    vis_q: jnp.ndarray          # [B] vision flow quality 0..255
    frontier: jnp.ndarray       # i32 [B, 4] latest frontier scores (scan ticks)


def sim_init(batch: int, key=None, geom: GridGeom = DEFAULT_GEOM,
             spread_m: float = 1.0, airborne: bool = False,
             hover_alt_m: float = 0.5) -> SimState:
    """airborne=True starts the fleet MID-MISSION: armed in GUIDED at
    hover altitude, behavior in EXPLORE with captured hover targets, and
    the mapper INITED at the start pose — so every scan tick from t=0
    runs a real map update (the ground start spends its first seconds in
    ARMING/TAKEOFF with mapping disabled; a 1,000-tick north-star bench
    measured an inert map path — round-5 fix)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    x0 = jax.random.uniform(k1, (batch,), jnp.float32, -spread_m, spread_m)
    y0 = jax.random.uniform(k2, (batch,), jnp.float32, -spread_m, spread_m)
    yaw0 = jax.random.uniform(k3, (batch,), jnp.float32, -180.0, 180.0)
    fc = fc_init(batch)
    beh = behavior_init(batch)
    mapper = mapping_init(batch, geom)
    ekf = ekf_init((batch,))
    alt = jnp.zeros((batch,), jnp.float32)
    if airborne:
        from micro_quad_slam_tpu.models.behavior import (
            ALT_RF, MODE_GUIDED, ST_EXPLORE)
        alt = jnp.full((batch,), hover_alt_m, jnp.float32)
        fc = fc._replace(armed=jnp.ones((batch,), bool),
                         mode=jnp.full((batch,), MODE_GUIDED, jnp.int32),
                         motor=jnp.full((batch,), 1500.0, jnp.float32))
        tb = lambda v: jnp.full((batch,), v)
        beh = beh._replace(
            st=jnp.full((batch,), ST_EXPLORE, jnp.int32),
            yaw_tv=tb(True), yaw_t=yaw0,
            hover_valid=tb(True), hover_x=x0, hover_y=y0,
            hover_z=-alt, hover_yaw=yaw0,
            alt_est=alt, alt_src=jnp.full((batch,), ALT_RF, jnp.int32),
            to_sent=tb(True), to_started=tb(True), armed_prev=tb(True),
            xy_since=jnp.ones((batch,), beh.xy_since.dtype))
        mapper = mapper._replace(inited=jnp.ones((batch,), bool),
                                 origin_x=x0, origin_y=y0)
        ekf = ekf_init((batch,), x0=x0, y0=y0, z0=alt,
                       yaw0=jnp.deg2rad(yaw0))
    return SimState(
        t_ms=jnp.int32(0),
        key=k3,
        x=x0, y=y0,
        yaw=yaw0,
        vx=jnp.zeros((batch,), jnp.float32),
        vy=jnp.zeros((batch,), jnp.float32),
        alt=alt,
        fc=fc,
        beh=beh,
        mapper=mapper,
        ekf=ekf,
        tof_min=jnp.full((batch, 4), jnp.nan, jnp.float32),
        scan_count=jnp.int32(0),
        cam_prev=jnp.zeros((batch, CAM_SIZE, CAM_SIZE), jnp.float32),
        cam_valid=jnp.array(False),
        vis_rate_x=jnp.full((batch,), jnp.nan, jnp.float32),
        vis_rate_y=jnp.full((batch,), jnp.nan, jnp.float32),
        vis_q=jnp.zeros((batch,), jnp.int32),
        frontier=jnp.zeros((batch, 4), jnp.int32),
    )


def _wrap(d):
    return jnp.mod(d + _F32(180.0), _F32(360.0)) - _F32(180.0)


def sim_step(state: SimState, world: World, cfg: PipelineConfig = UL_PROFILE,
             geom: GridGeom = DEFAULT_GEOM, dt_ms: int = 20,
             scan_period_ms: int = 100, noise_mm: float = 5.0,
             dropout_p: float = 0.02, want_arm=True, record: bool = False,
             vision_flow: bool = False, flow_period_ms: int = 100):
    """One closed-loop control tick for the whole swarm.  With record=True
    the per-step diagnostics include the raw scan cells (zeros between
    scan ticks) so a run can be converted to reference-format scanlogs."""
    if state.x.shape[0] != world.room.shape[0]:
        raise ValueError(
            f"batch mismatch: SimState has {state.x.shape[0]} quads but "
            f"World has {world.room.shape[0]} (sim_init(batch) and "
            f"make_world(batch) must use the same batch)")
    W = jnp.where
    B = state.x.shape[0]
    t = state.t_ms + dt_ms
    dt = _F32(dt_ms * 1e-3)
    key, k_scan = jax.random.split(state.key)
    fc = state.fc
    mapper = state.mapper

    # ---- scan tick: synth ToF + map update (expensive; real branch) ----
    scan_due = (t % scan_period_ms) == 0
    cells0 = jnp.zeros((B, 4, 8, 8), jnp.uint16)

    def do_scan(op):
        mapper, tof_min, ekf, _ = op
        cells = synth_scan_mm(world, state.x, state.y, state.yaw, k_scan,
                              noise_mm, dropout_p, cfg)
        beams, minima = extract_beams(cells, cfg.tof)
        # map update from the EKF pose estimate (self-localized mapping)
        ex_, ey_ = ekf.mean[..., 0], ekf.mean[..., 1]
        grid = jax.vmap(
            lambda gi, b, xi, yi, yawi, oxi, oyi, en:
            apply_scan_to_grid(gi, b, xi, yi, yawi, oxi, oyi, en,
                               cfg.map, cfg.tof, geom)
        )(mapper.grid, beams, ex_, ey_, state.yaw, mapper.origin_x,
          mapper.origin_y, mapper.inited)
        mapper = mapper._replace(grid=grid)
        return mapper, minima, ekf, cells

    mapper, tof_min, _, scan_cells = lax.cond(
        scan_due, do_scan, lambda op: op,
        (mapper, state.tof_min, state.ekf, cells0)
    )

    # ---- flow: oracle sensor model, or REAL pyramidal LK on rendered
    # downward-camera frames (BASELINE config 3 end-to-end) ----
    yaw_rad = jnp.deg2rad(state.yaw)
    ground = jnp.maximum(state.alt, 0.0)
    airborne = state.alt > 0.05
    cam_prev, cam_valid = state.cam_prev, state.cam_valid
    vis_rx, vis_ry, vis_q = state.vis_rate_x, state.vis_rate_y, state.vis_q
    if vision_flow:
        from micro_quad_slam_tpu.ops.flow import (
            flow_to_rates, lk_flow_batched, render_camera_frame)

        assert flow_period_ms % dt_ms == 0, (
            "flow_period_ms must be a multiple of dt_ms (the rate "
            "conversion divides by the true inter-frame time)")
        flow_due = (t % flow_period_ms) == 0

        def do_flow(op):
            prev, valid, rx0, ry0, q0 = op
            cur = jax.vmap(
                lambda xi, yi, ai, wi: render_camera_frame(
                    xi, yi, jnp.maximum(ai, 0.05), wi, CAM_SIZE, CAM_FOCAL)
            )(state.x, state.y, state.alt, yaw_rad)
            res = lk_flow_batched(prev, cur)
            # camera x = body x at yaw 0 by construction of the renderer
            rx, ry = flow_to_rates(res.dx_px, res.dy_px,
                                   _F32(flow_period_ms * 1e-3), CAM_FOCAL)
            q = jnp.clip(res.quality, 0, 255).astype(jnp.int32)
            rx = W(valid, rx, jnp.nan)
            ry = W(valid, ry, jnp.nan)
            q = W(valid, q, 0)
            return cur, jnp.array(True), rx, ry, q

        cam_prev, cam_valid, vis_rx, vis_ry, vis_q = lax.cond(
            flow_due, do_flow, lambda op: op,
            (cam_prev, cam_valid, vis_rx, vis_ry, vis_q))
        of_rate_x = W(airborne, vis_rx, jnp.nan)
        of_rate_y = W(airborne, vis_ry, jnp.nan)
        of_q = W(airborne, vis_q, 0).astype(jnp.int32)
    else:
        vbx = jnp.cos(yaw_rad) * state.vx + jnp.sin(yaw_rad) * state.vy
        vby = -jnp.sin(yaw_rad) * state.vx + jnp.cos(yaw_rad) * state.vy
        of_rate_x = W(ground > 0.05, vbx / jnp.maximum(ground, 0.05), jnp.nan)
        of_rate_y = W(ground > 0.05, vby / jnp.maximum(ground, 0.05), jnp.nan)
        of_q = W(airborne, 85, 0).astype(jnp.int32)
    ekf, _diag = ekf_step(state.ekf, jnp.full((B,), dt), of_rate_x, of_rate_y,
                          of_q, ground, yaw_rad, cfg.ekf)
    # seed the EKF position while on the ground (perfect initial fix)
    on_gnd = ~airborne
    mean = ekf.mean
    mean = mean.at[..., 0].set(W(on_gnd, state.x, mean[..., 0]))
    mean = mean.at[..., 1].set(W(on_gnd, state.y, mean[..., 1]))
    ekf = EkfState(mean, ekf.cov)

    # ---- frontier queries from the mapper grid (B7) ----
    # refreshed on scan ticks only: the grid only changes then, the
    # reference re-evaluates frontiers at retarget cadence (~1 Hz,
    # uav_local_nav.c:370-420), and the whole-grid query dominated the
    # 1 kHz tick cost when run every step.
    def do_frontier(_):
        return jax.vmap(
            lambda g, xi, yi, yawi, oxi, oyi, ini: frontier_scores(
                g, xi, yi, yawi, (0.0, 90.0, -90.0, 180.0), oxi, oyi, ini,
                cfg.map, geom)
        )(mapper.grid, ekf.mean[..., 0], ekf.mean[..., 1], state.yaw,
          mapper.origin_x, mapper.origin_y, mapper.inited)

    fr = lax.cond(scan_due, do_frontier, lambda _: state.frontier,
                  operand=None)

    # ---- telemetry assembly (the FC/L1 interface, SURVEY §3.5) ----
    bt = jnp.broadcast_to(t, (B,)).astype(jnp.int32)
    tm = {
        "t_ms": bt,
        "have_fc": jnp.ones((B,), bool),
        "fc_armed": fc.armed,
        "hb_custom_mode": fc.mode,
        "have_ext": jnp.ones((B,), bool),
        "landed_state": W(airborne, 2, 1).astype(jnp.int32),
        "have_sys": jnp.ones((B,), bool),
        "sys_last_ms": bt,
        "sys_health": jnp.full((B,), HEALTH_ALL, jnp.uint32),
        "have_servo": jnp.ones((B,), bool),
        "servo_last_ms": bt,
        "motor_avg": fc.motor,
        "batt_vpc": fc.batt_v * _F32(0.5),
        "batt_cells": jnp.full((B,), 2, jnp.int32),
        "batt_last_ms": bt,
        # intake latch as handle_battery_status would set it for a
        # 2-cell reading (clean:1286-1294)
        "batt_valid": ((fc.batt_v >= _F32(3.0)) & (fc.batt_v <= _F32(30.0))
                       & (fc.batt_v * _F32(0.5) >= _F32(2.5))
                       & (fc.batt_v * _F32(0.5) <= _F32(4.8))),
        "have_lpos": jnp.ones((B,), bool),
        "lpos_last_ms": bt,
        "lpos_x": ekf.mean[..., 0],
        "lpos_y": ekf.mean[..., 1],
        "lpos_alt_filt": state.alt,
        "have_att": jnp.ones((B,), bool),
        "yaw_deg": state.yaw,
        "have_of": jnp.ones((B,), bool),
        "of_last_ms": bt,
        "of_q": of_q,
        "have_rf": airborne,
        "rf_last_ms": W(airborne, bt, jnp.maximum(bt - 1000, 0)),
        "rf_m": W(airborne, state.alt, jnp.nan),
        "want_arm": jnp.broadcast_to(jnp.asarray(want_arm), (B,)),
        "have_takeoff_ack": fc.have_ack,
        "takeoff_ack_res": fc.ack_res,
        "takeoff_ack_ms": fc.ack_ms,
        "takeoff_accept_ms": fc.accept_ms,
        "tof_min": tof_min,
        "map_inited": mapper.inited,
        "frontier_f": fr[..., 0],
        "frontier_r": fr[..., 1],
        "frontier_l": fr[..., 2],
        "frontier_b": fr[..., 3],
    }

    # ---- behavior tick ----
    beh, out = behavior_step(state.beh, tm, cfg)

    # ---- map init on hover lock (uav_local_nav.c:2187-2194) ----
    minit = out["map_init"] & ~mapper.inited
    mapper = mapper._replace(
        origin_x=W(minit, out["map_origin_x"], mapper.origin_x),
        origin_y=W(minit, out["map_origin_y"], mapper.origin_y),
        inited=mapper.inited | minit,
    )

    # ---- FC applies outputs ----
    fc = fc._replace(mode=W(out["req_mode"] >= 0, out["req_mode"], fc.mode))
    fc = fc._replace(armed=W(out["req_arm"] == 1, True,
                             W(out["req_arm"] == 0, False, fc.armed)))
    to_req = jnp.isfinite(out["req_takeoff"])
    fc = fc._replace(
        have_ack=fc.have_ack | to_req,
        ack_res=W(to_req, 0, fc.ack_res),
        ack_ms=W(to_req, bt, fc.ack_ms),
        accept_ms=W(to_req, bt, fc.accept_ms),
        takeoff_active=fc.takeoff_active | to_req,
        takeoff_target=W(to_req, out["req_takeoff"], fc.takeoff_target),
    )
    clear = out["clear_takeoff_ack"]
    fc = fc._replace(
        have_ack=W(clear, False, fc.have_ack),
        ack_ms=W(clear, 0, fc.ack_ms),
        accept_ms=W(clear, 0, fc.accept_ms),
    )
    kind = out["cmd_kind"]
    cmd = out["cmd"]
    fc = fc._replace(
        vset_bx=W(kind == CMD_VEL_BODY, cmd[..., 0], 0.0),
        vset_by=W(kind == CMD_VEL_BODY, cmd[..., 1], 0.0),
        yaw_rate_cmd=W(kind == CMD_VEL_BODY, cmd[..., 3], 0.0),
        climb_cmd=W(kind == CMD_VEL_NED, -cmd[..., 2], 0.0),
        pos_hold=kind == CMD_POS_YAW,
        pos_cmd=W((kind == CMD_POS_YAW)[..., None], cmd[..., :3], fc.pos_cmd),
        pos_cmd_yaw=W(kind == CMD_POS_YAW, cmd[..., 3], fc.pos_cmd_yaw),
    )

    # ---- dynamics ----
    spool = fc.armed & (fc.takeoff_active | airborne)
    motor = W(fc.armed, W(spool, jnp.minimum(fc.motor + _F32(900.0) * dt,
                                             _F32(1600.0)), fc.motor),
              _F32(1000.0))
    lifted = fc.armed & (motor > _F32(1150.0))

    # vertical
    climb = jnp.zeros((B,), jnp.float32)
    climb = W(fc.takeoff_active & (state.alt < fc.takeoff_target),
              _F32(0.45), climb)
    climb = W(fc.mode == MODE_LAND, _F32(-0.35), climb)
    climb = W(fc.climb_cmd != 0, fc.climb_cmd, climb)
    climb = W(fc.pos_hold, jnp.clip((-fc.pos_cmd[..., 2]) - state.alt,
                                    -0.3, 0.3), climb)
    alt = W(lifted, jnp.maximum(state.alt + climb * dt, 0.0),
            jnp.maximum(state.alt - _F32(1.0) * dt, 0.0))
    fc = fc._replace(takeoff_active=fc.takeoff_active
                     & ~(alt >= fc.takeoff_target), motor=motor)

    # horizontal: body velocity setpoint or position P-control
    yaw_r = jnp.deg2rad(state.yaw)
    vwx_set = jnp.cos(yaw_r) * fc.vset_bx - jnp.sin(yaw_r) * fc.vset_by
    vwy_set = jnp.sin(yaw_r) * fc.vset_bx + jnp.cos(yaw_r) * fc.vset_by
    px = jnp.clip((fc.pos_cmd[..., 0] - ekf.mean[..., 0]) * _F32(1.0), -0.5, 0.5)
    py = jnp.clip((fc.pos_cmd[..., 1] - ekf.mean[..., 1]) * _F32(1.0), -0.5, 0.5)
    vwx_set = W(fc.pos_hold, px, vwx_set)
    vwy_set = W(fc.pos_hold, py, vwy_set)
    act = lifted & airborne
    tau = _F32(0.4)
    vx = W(act, state.vx + (vwx_set - state.vx) * jnp.minimum(dt / tau, 1.0),
           _F32(0.0))
    vy = W(act, state.vy + (vwy_set - state.vy) * jnp.minimum(dt / tau, 1.0),
           _F32(0.0))
    x = state.x + vx * dt
    y = state.y + vy * dt
    # stay inside the room (walls are solid)
    margin = _F32(0.15)
    x = jnp.clip(x, world.room[..., 0] + margin, world.room[..., 2] - margin)
    y = jnp.clip(y, world.room[..., 1] + margin, world.room[..., 3] - margin)
    yaw = _wrap(state.yaw + W(act, fc.yaw_rate_cmd, 0.0) * dt)

    new_state = SimState(
        t_ms=jnp.int32(t), key=key, x=x, y=y, yaw=yaw, vx=vx, vy=vy,
        alt=alt, fc=fc, beh=beh, mapper=mapper, ekf=ekf, tof_min=tof_min,
        scan_count=state.scan_count + W(scan_due, 1, 0).astype(jnp.int32),
        cam_prev=cam_prev, cam_valid=cam_valid, vis_rate_x=vis_rx,
        vis_rate_y=vis_ry, vis_q=vis_q, frontier=fr,
    )
    diag = {
        "state": out["state"],
        "alt": alt,
        "pose_err": jnp.hypot(ekf.mean[..., 0] - x, ekf.mean[..., 1] - y),
    }
    if record:
        # everything a scanrec needs (uav_local_nav.c:1549-1581), sampled
        # at this tick; host-side conversion filters to scan ticks
        diag.update({
            "scan_due": jnp.broadcast_to(scan_due, (B,)),
            "t_ms": jnp.broadcast_to(jnp.int32(t), (B,)),
            "cells": scan_cells,
            "est_x": ekf.mean[..., 0],
            "est_y": ekf.mean[..., 1],
            "yaw": yaw,
            "alt_est": out["alt_est"],
            "rf": W(airborne, alt, jnp.nan),
            "of_rate_x": of_rate_x,
            "of_rate_y": of_rate_y,
            "of_q": of_q.astype(jnp.uint8),
            "kf_flags": out["kf_flags"].astype(jnp.uint8),
            "cmd_kind": out["cmd_kind"],
            "cmd": out["cmd"],
            "req_mode": out["req_mode"],
            "req_arm": out["req_arm"],
            "req_takeoff": out["req_takeoff"],
            "rc_release": out["rc_release"],
        })
    return new_state, diag


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def sim_run(state: SimState, world: World, n_steps: int,
            cfg: PipelineConfig = UL_PROFILE, geom: GridGeom = DEFAULT_GEOM,
            dt_ms: int = 20, scan_period_ms: int = 100,
            record: bool = False, vision_flow: bool = False):
    """Run n_steps closed-loop ticks under one jit; returns final state +
    stacked diagnostics (with raw scans when record=True).  vision_flow
    replaces the oracle flow sensor with real pyramidal LK on rendered
    downward-camera frames."""

    def step(st, _):
        st, diag = sim_step(st, world, cfg, geom, dt_ms, scan_period_ms,
                            record=record, vision_flow=vision_flow)
        return st, diag

    return lax.scan(step, state, None, length=n_steps)


def sim_diag_to_mavlink(diag: dict, quad: int = 0, tgt_sys: int = 1,
                        tgt_comp: int = 1) -> bytes:
    """Render one quad's recorded command outputs as the MAVLink byte
    stream the reference would have written to its FC UART (L1 boundary;
    heartbeat at 1 Hz like send_own_heartbeat_tick, uav_local_nav.c:682)."""
    from micro_quad_slam_tpu.formats.mavlink import (
        MavEncoder, encode_command_stream)

    enc = MavEncoder()
    t_all = np.asarray(diag["t_ms"])[:, quad]
    buf = b""
    last_hb = -10 ** 9
    for k in range(t_all.shape[0]):
        t = int(t_all[k])
        hb_due = t - last_hb >= 1000
        if hb_due:
            last_hb = t
        out = {
            "req_mode": int(np.asarray(diag["req_mode"])[k, quad]),
            "req_arm": int(np.asarray(diag["req_arm"])[k, quad]),
            "req_takeoff": float(np.asarray(diag["req_takeoff"])[k, quad]),
            "cmd_kind": int(np.asarray(diag["cmd_kind"])[k, quad]),
            "cmd": np.asarray(diag["cmd"])[k, quad],
            "rc_release": bool(np.asarray(diag["rc_release"])[k, quad]),
        }
        buf += encode_command_stream(enc, t, out, tgt_sys, tgt_comp, hb_due)
    return buf


def sim_diag_to_scanlogs(diag: dict) -> list:
    """Convert a recorded sim run's diagnostics to one reference-format
    ScanLog per quad (the sim twin of the reference's scanlog writer,
    uav_local_nav.c:1549-1581).  Keyframe flags accumulated between scans
    are drained into the next record, like the reference."""
    from micro_quad_slam_tpu.formats.scanlog import ScanLog

    scan_due = np.asarray(diag["scan_due"])          # [T, B]
    T, B = scan_due.shape
    logs = []
    for b in range(B):
        idx = np.nonzero(scan_due[:, b])[0]
        n = len(idx)

        def g(key, dtype, i=idx, b=b):
            return np.ascontiguousarray(
                np.asarray(diag[key])[i, b].astype(dtype))

        # drain kf flags: OR of flags since the previous scan tick
        kf_all = np.asarray(diag["kf_flags"])[:, b]
        kf = np.zeros(n, np.uint8)
        prev = 0
        prev_flags = 0
        for k, i in enumerate(idx):
            acc = 0
            for j in range(prev, i + 1):
                acc |= int(kf_all[j])
            new_bits = acc & ~prev_flags
            kf[k] = new_bits
            prev_flags = acc
            prev = i + 1
        t_ms = g("t_ms", np.uint32)
        logs.append(ScanLog(
            host_ms=t_ms, scan_ms=t_ms.copy(),
            x_m=g("est_x", np.float32), y_m=g("est_y", np.float32),
            yaw_deg=g("yaw", np.float32), alt_m=g("alt_est", np.float32),
            roll_rad=np.zeros(n, np.float32),
            pitch_rad=np.zeros(n, np.float32),
            rf_m=g("rf", np.float32),
            of_rate_x=g("of_rate_x", np.float32),
            of_rate_y=g("of_rate_y", np.float32),
            of_q=g("of_q", np.uint8), state=g("state", np.uint8),
            kf_flags=kf, sys_health=np.zeros(n, np.uint32),
            grid_mm=np.asarray(diag["cells"])[idx, b].astype(np.uint16),
        ))
    return logs
