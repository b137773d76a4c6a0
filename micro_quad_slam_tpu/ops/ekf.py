"""Explicit full-pose EKF: optical flow + rangefinder + attitude fusion.

The reference consumed a pose estimated ONBOARD the flight controller
(ArduPilot EKF3 fusing IMU + optical flow + rangefinder) via
LOCAL_POSITION_NED (uav_local_nav.c:1168-1195) — the estimator itself
lives in firmware outside the repo.  The rebuild brings that capability
inside the framework as an explicit, jittable EKF so pose tracks can be
*recomputed* from the raw logged sensor streams (scanrec carries flow
rates, quality, rangefinder and attitude — uav_local_nav.c:1522-1547) and
batched over thousands of replays.

Model (per quad, all float32, batched over any leading dims):

  state   s = [x, y, vx, vy, z, vz, yaw, wz]
          (world NED xy + up-positive altitude z, yaw in rad, wz rad/s;
          indices 0-3 deliberately match the historical 4-state layout)
  predict constant-velocity / constant-yaw-rate; P' = F P F^T + Q(dt)
  updates (each gated independently, Joseph-form covariance):
    yaw   <- logged ATTITUDE yaw as a direct measurement with a
             wrap-aware innovation (EKF3 fuses the AHRS quaternion;
             here the logged attitude stands in for it)
    z     <- rangefinder distance (DISTANCE_SENSOR orient 25 /
             RANGEFINDER, uav_local_nav.c:1197-1242)
    v_xy  <- flow-derived BODY-frame velocity z_b = flow_rate * ground
             (the reference's displacement convention, of_comp_m =
             integrated * ground, uav_local_nav.c:1159-1165), with the
             full measurement Jacobian h(s) = R(-yaw) [vx, vy]^T —
             including the d/dyaw column, so yaw uncertainty feeds the
             velocity gain instead of the logged yaw being trusted
             verbatim.

Measurement gating mirrors the reference's flow-quality thresholds
(quality >= 50, uav_local_nav.c:943): a bad-flow frame gets no velocity
update (pure dead-reckoning), exactly like EKF3 rejecting a bad flow
sample.

Shape note: F and every H here are so sparse that all covariance
algebra is EXPANDED into static shifts and rank-1/rank-2 outer products
instead of batched 8x8 einsums — tiny [B, 8, 8] matmuls can fragment
XLA's fusion clusters inside the replay scan (the scan is latency-bound,
not FLOP-bound), while the expanded forms fuse into a handful of
elementwise kernels per step (re-checking this layout on the GPU is
ROADMAP S7).  The expansion reads P by rows and columns, so
ekf_step re-symmetrizes P once per step (f32 asymmetry otherwise
compounds; the circle replay measurably diverged at ~frame 110).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from micro_quad_slam_tpu.utils.config import EkfConfig

_F32 = np.float32
_N = 8
_IX, _IY, _IVX, _IVY, _IZ, _IVZ, _IYAW, _IWZ = range(_N)


class EkfState(NamedTuple):
    mean: jnp.ndarray   # f32 [..., 8]  (x, y, vx, vy, z, vz, yaw, wz)
    cov: jnp.ndarray    # f32 [..., 8, 8]


def ekf_init(batch: tuple = (), x0=0.0, y0=0.0, pos_var=1e-4,
             vel_var=1e-2, z0=0.0, yaw0=0.0, yaw_var=1e-2) -> EkfState:
    mean = jnp.zeros(batch + (_N,), jnp.float32)
    mean = mean.at[..., _IX].set(x0).at[..., _IY].set(y0)
    mean = mean.at[..., _IZ].set(z0).at[..., _IYAW].set(yaw0)
    cov = jnp.zeros(batch + (_N, _N), jnp.float32)
    for i in (_IX, _IY, _IZ):
        cov = cov.at[..., i, i].set(pos_var)
    for i in (_IVX, _IVY, _IVZ):
        cov = cov.at[..., i, i].set(vel_var)
    cov = cov.at[..., _IYAW, _IYAW].set(yaw_var)
    cov = cov.at[..., _IWZ, _IWZ].set(1e-2)
    return EkfState(mean, cov)


def ekf_predict(state: EkfState, dt, cfg: EkfConfig = EkfConfig()) -> EkfState:
    """Constant-velocity / constant-yaw-rate predict, dt-scaled noise.

    F = I + dt*E with E just the four (pos, vel) couplings, so
    F P F^T = P + dt*(E P + (E P)^T) + dt^2 * E P E^T evaluates as
    static row/column shifts and fused elementwise math — no batched
    8x8 matmuls: per-step [B, 8, 8] einsums can fragment XLA fusion
    clusters inside the replay scan; the expanded form fuses into the
    surrounding step body."""
    dt = jnp.asarray(dt, jnp.float32)
    mean, P = state.mean, state.cov
    d = dt[..., None]
    # mean: pos += vel*dt on the four coupled pairs
    vel_of = mean[..., (_IVX, _IVY, _IVZ, _IWZ)]
    mean = mean.at[..., (_IX, _IY, _IZ, _IYAW)].add(vel_of * d)

    # (E P)[i, :] = P[vel(i), :] for coupled rows i, else 0 — a static
    # row gather.  Build the row map pos<-vel once.
    rowmap = list(range(_N))
    for pos, vel in ((_IX, _IVX), (_IY, _IVY), (_IZ, _IVZ), (_IYAW, _IWZ)):
        rowmap[pos] = vel
    sel = np.zeros(_N, np.float32)
    for pos in (_IX, _IY, _IZ, _IYAW):
        sel[pos] = 1.0
    selr = jnp.asarray(sel)[:, None]                     # [8, 1]
    EP = P[..., rowmap, :] * selr                        # [..., 8, 8]
    EPEt = EP[..., :, rowmap] * selr[:, 0]               # cols likewise
    dt2 = d[..., None]
    cov = P + dt2 * (EP + jnp.swapaxes(EP, -1, -2)) + dt2 * dt2 * EPEt

    qdiag = [cfg.q_pos, cfg.q_pos, cfg.q_vel, cfg.q_vel,
             cfg.q_pos, cfg.q_vz, cfg.q_yaw, cfg.q_wz]
    q = jnp.stack([jnp.broadcast_to(_F32(v) * dt, dt.shape)
                   for v in qdiag], axis=-1)
    cov = cov + q[..., None] * jnp.eye(_N, dtype=jnp.float32)
    return EkfState(mean, cov)


def flow_world_velocity(of_rate_x, of_rate_y, ground_m, yaw_rad):
    """Flow rates (rad/s) + ground distance -> world-frame velocity [..., 2].

    Body velocity = rate * ground (reference displacement convention,
    uav_local_nav.c:1159-1165), rotated to world by yaw."""
    vbx = of_rate_x * ground_m
    vby = of_rate_y * ground_m
    c, s = jnp.cos(yaw_rad), jnp.sin(yaw_rad)
    vwx = c * vbx - s * vby
    vwy = s * vbx + c * vby
    return jnp.stack([vwx, vwy], axis=-1)


def _update_scalar(state: EkfState, idx: int, innov, valid, r) -> EkfState:
    """Scalar measurement on state component idx with given innovation.

    Joseph form expanded for H = e_idx^T (rank-1):
      (I - K e^T) P (I - K e^T)^T + r K K^T
        = P - K (x) P[idx, :] - P[:, idx] (x) K + (P[idx, idx] + r) K (x) K
    — pure outer products that fuse, instead of three batched 8x8
    matmuls per update inside the replay scan."""
    mean, cov = state.mean, state.cov
    r = jnp.asarray(r, jnp.float32)
    S = cov[..., idx, idx] + r
    K = cov[..., :, idx] / S[..., None]                       # [..., 8]
    new_mean = mean + K * innov[..., None]
    Kc = K[..., :, None]                                      # [..., 8, 1]
    Kr = K[..., None, :]                                      # [..., 1, 8]
    prow = cov[..., idx:idx + 1, :]                           # [..., 1, 8]
    pcol = cov[..., :, idx:idx + 1]                           # [..., 8, 1]
    new_cov = (cov - Kc * prow - pcol * Kr
               + S[..., None, None] * (Kc * Kr))
    v = valid[..., None]
    return EkfState(jnp.where(v, new_mean, mean),
                    jnp.where(valid[..., None, None], new_cov, cov))


def wrap_pi(a):
    """Wrap radians to [-pi, pi)."""
    two_pi = _F32(2.0 * np.pi)
    return a - two_pi * jnp.floor((a + _F32(np.pi)) / two_pi)


def ekf_update_yaw(state: EkfState, yaw_meas, valid, r_yaw) -> EkfState:
    """Attitude yaw as a direct measurement, wrap-aware innovation."""
    innov = wrap_pi(jnp.where(valid, yaw_meas, 0.0)
                    - state.mean[..., _IYAW])
    return _update_scalar(state, _IYAW, innov, valid, r_yaw)


def ekf_update_rangefinder(state: EkfState, rf_m, valid, r_rf) -> EkfState:
    """Rangefinder distance as a direct altitude measurement."""
    innov = jnp.where(valid, rf_m, 0.0) - state.mean[..., _IZ]
    return _update_scalar(state, _IZ, innov, valid, r_rf)


def ekf_update_velocity(state: EkfState, z_body, valid, r_vel) -> tuple:
    """Flow body-velocity update with the full EKF Jacobian.

    h(s) = R(-yaw) [vx, vy]^T; H has nonzero columns at (vx, vy, yaw).
    z_body: [..., 2] measured body velocity.  Returns (state, world-frame
    innovation [..., 2] for diagnostics)."""
    mean, cov = state.mean, state.cov
    r_vel = jnp.asarray(r_vel, jnp.float32)
    c = jnp.cos(mean[..., _IYAW])
    s = jnp.sin(mean[..., _IYAW])
    vx, vy = mean[..., _IVX], mean[..., _IVY]

    # h(s); the Jacobian rows H[0] = c e_vx + s e_vy + h0y e_yaw,
    # H[1] = -s e_vx + c e_vy + h1y e_yaw stay implicit below
    hb = jnp.stack([c * vx + s * vy, -s * vx + c * vy], axis=-1)

    innov_b = z_body - hb
    # H's only nonzero columns are (vx, vy, yaw), so every matrix
    # product below expands into a handful of [..., 8]-vector combos
    # and rank-1 outer products that fuse — no batched 8x8 matmuls
    # (same expansion rationale as ekf_predict/_update_scalar).
    h0y = -s * vx + c * vy
    h1y = -c * vx - s * vy
    Pvx = cov[..., :, _IVX]
    Pvy = cov[..., :, _IVY]
    Pyw = cov[..., :, _IYAW]
    un = lambda a_: a_[..., None]
    PHt0 = un(c) * Pvx + un(s) * Pvy + un(h0y) * Pyw      # [..., 8]
    PHt1 = un(-s) * Pvx + un(c) * Pvy + un(h1y) * Pyw
    dotH0 = lambda p: c * p[..., _IVX] + s * p[..., _IVY] \
        + h0y * p[..., _IYAW]
    dotH1 = lambda p: -s * p[..., _IVX] + c * p[..., _IVY] \
        + h1y * p[..., _IYAW]
    a = dotH0(PHt0) + r_vel
    b = dotH0(PHt1)
    c2 = dotH1(PHt0)
    d = dotH1(PHt1) + r_vel
    det = a * d - b * c2
    i00, i01 = d / det, -b / det
    i10, i11 = -c2 / det, a / det
    K0 = PHt0 * un(i00) + PHt1 * un(i10)                  # [..., 8]
    K1 = PHt0 * un(i01) + PHt1 * un(i11)

    new_mean = mean + K0 * un(innov_b[..., 0]) + K1 * un(innov_b[..., 1])

    # Joseph: (I - M) P (I - M)^T + r (K0 (x) K0 + K1 (x) K1), with
    # M = K H having nonzero columns only at (vx, vy, yaw)
    Mvx = un(c) * K0 + un(-s) * K1                        # M[:, vx]
    Mvy = un(s) * K0 + un(c) * K1
    Myw = un(h0y) * K0 + un(h1y) * K1
    row = lambda i: cov[..., i, :]
    MP = (Mvx[..., :, None] * row(_IVX)[..., None, :]
          + Mvy[..., :, None] * row(_IVY)[..., None, :]
          + Myw[..., :, None] * row(_IYAW)[..., None, :])  # [..., 8, 8]
    MPM = (MP[..., :, _IVX, None] * Mvx[..., None, :]
           + MP[..., :, _IVY, None] * Mvy[..., None, :]
           + MP[..., :, _IYAW, None] * Myw[..., None, :])
    KK = (K0[..., :, None] * K0[..., None, :]
          + K1[..., :, None] * K1[..., None, :])
    new_cov = (cov - MP - jnp.swapaxes(MP, -1, -2) + MPM
               + r_vel[..., None, None] * KK)

    v = valid[..., None]
    mean = jnp.where(v, new_mean, mean)
    cov = jnp.where(valid[..., None, None], new_cov, cov)
    # world-frame innovation for diagnostics (back-rotate)
    innov_w = jnp.stack([c * innov_b[..., 0] - s * innov_b[..., 1],
                         s * innov_b[..., 0] + c * innov_b[..., 1]],
                        axis=-1)
    return EkfState(mean, cov), jnp.where(v, innov_w, 0.0)


def ekf_step(
    state: EkfState,
    dt,
    of_rate_x, of_rate_y, of_q, ground_m, yaw_rad,
    cfg: EkfConfig = EkfConfig(),
):
    """One predict + (yaw, rangefinder, flow) update cycle from raw
    scanrec sensor fields.

    Gating: flow rates finite, quality >= cfg.min_flow_quality, ground
    distance finite and > cfg.min_ground_m (mirrors the reference's flow
    gates, uav_local_nav.c:942-944); the rangefinder fuses into z under
    the same freshness proxy; logged attitude yaw fuses whenever finite.
    Returns (state, diag dict)."""
    v_prev = state.mean[..., _IVX:_IVY + 1]
    state = ekf_predict(state, dt, cfg)

    yaw_ok = jnp.isfinite(yaw_rad)
    state = ekf_update_yaw(state, yaw_rad, yaw_ok, _F32(cfg.r_yaw))

    rf_ok = jnp.isfinite(ground_m) & (ground_m > _F32(cfg.min_ground_m)) \
        & (ground_m < _F32(10.0))
    state = ekf_update_rangefinder(state, ground_m, rf_ok, _F32(cfg.r_rf))

    valid = (
        jnp.isfinite(of_rate_x) & jnp.isfinite(of_rate_y)
        & (of_q >= cfg.min_flow_quality)
        & jnp.isfinite(ground_m) & (ground_m > _F32(cfg.min_ground_m))
    )
    z_body = jnp.stack([jnp.where(valid, of_rate_x * ground_m, 0.0),
                        jnp.where(valid, of_rate_y * ground_m, 0.0)],
                       axis=-1)
    state, innov = ekf_update_velocity(state, z_body, valid,
                                       _F32(cfg.r_flow_vel))
    # trapezoidal position refinement: the predict used the backward
    # velocity over [t-1, t]; upgrade the Euler increment to the
    # trapezoid 0.5*(v_prev + v_new)*dt.  When the update was gated off,
    # v_new == v_prev and this is a no-op.
    v_new = state.mean[..., _IVX:_IVY + 1]
    dt_arr = jnp.asarray(dt, jnp.float32)[..., None]
    corr = _F32(0.5) * (v_new - v_prev) * dt_arr
    mean = state.mean.at[..., _IX:_IY + 1].add(corr)
    # the rank-1-expanded updates read P by rows AND columns, so f32
    # asymmetry would otherwise compound across steps (measured: the
    # circle replay diverged at ~frame 110 without this); one fused
    # elementwise symmetrization per step pins P symmetric
    cov = _F32(0.5) * (state.cov + jnp.swapaxes(state.cov, -1, -2))
    state = EkfState(mean, cov)
    return state, {"flow_used": valid, "innovation": innov}
