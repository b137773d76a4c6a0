"""Fusion replay: recompute the pose track with the explicit EKF, and
optionally drive mapping from it (BASELINE.json config 2: "batched replay
... vectorized grid-update + EKF fusion kernels").

The reference never estimated pose itself — it logged ArduPilot EKF3's
LOCAL_POSITION_NED (uav_local_nav.c:1168-1195) alongside the raw flow and
rangefinder streams in each scanrec.  This module replays those raw
streams through micro_quad_slam_tpu.ops.ekf and measures the recomputed
track against the logged one (north-star: pose RMSE <= 1 cm on recorded
flights), batched over flights exactly like the mapping replay.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.ops.ekf import EkfState, ekf_init, ekf_step
from micro_quad_slam_tpu.utils.config import PipelineConfig, UL_PROFILE

_F32 = np.float32


def fusion_arrays(scanlog) -> dict:
    """Host-side: ScanLog -> EKF replay inputs [T]."""
    return {
        "scan_ms": np.ascontiguousarray(scanlog.scan_ms).astype(np.int64),
        "of_rate_x": np.ascontiguousarray(scanlog.of_rate_x),
        "of_rate_y": np.ascontiguousarray(scanlog.of_rate_y),
        "of_q": np.ascontiguousarray(scanlog.of_q).astype(np.int32),
        "rf_m": np.ascontiguousarray(scanlog.rf_m),
        "yaw_deg": np.ascontiguousarray(scanlog.yaw_deg),
        "x_m": np.ascontiguousarray(scanlog.x_m),
        "y_m": np.ascontiguousarray(scanlog.y_m),
    }


def _ekf_replay_batched(frames: dict, cfg: PipelineConfig, extra=None):
    """frames: [B, T] arrays -> (final EkfState [B], track dict [B, T]).

    extra: optional (init_carry, step_fn) hook run INSIDE the same scan;
    step_fn(carry, mean, frame) -> (carry, out_dict) sees the posterior
    mean of each step.  Used by the SLAM pipeline to fuse its
    origin/recenter schedule into this scan — a second T-length scan
    would add its own per-step loop overhead — while keeping the EKF
    itself defined in exactly one place."""
    B, T = frames["of_rate_x"].shape
    # dt from the sensor-side clock (dual-clock scheme,
    # uav_local_nav.c:1362-1364); first frame gets dt=0.
    ms = frames["scan_ms"]
    dt = jnp.diff(ms, axis=1, prepend=ms[:, :1]).astype(jnp.float32) * _F32(1e-3)
    dt = jnp.clip(dt, 0.0, 1.0)  # guard clock glitches / wraps

    # seed position from the first finite logged pose so the recomputed
    # track is comparable to the logged one; yaw/z seed from the first
    # attitude / rangefinder samples (they re-converge in one update)
    x0 = jnp.nan_to_num(frames["x_m"][:, 0], nan=0.0)
    y0 = jnp.nan_to_num(frames["y_m"][:, 0], nan=0.0)
    yaw0 = jnp.nan_to_num(jnp.deg2rad(frames["yaw_deg"][:, 0]), nan=0.0)
    z0 = jnp.nan_to_num(frames["rf_m"][:, 0], nan=0.0)
    state0 = ekf_init((B,), 0.0, 0.0)
    state0 = EkfState(
        state0.mean.at[:, 0].set(x0).at[:, 1].set(y0)
        .at[:, 4].set(z0).at[:, 6].set(yaw0),
        state0.cov,
    )

    seq = {
        "dt": jnp.moveaxis(dt, 0, 1),
        "rx": jnp.moveaxis(frames["of_rate_x"], 0, 1),
        "ry": jnp.moveaxis(frames["of_rate_y"], 0, 1),
        "q": jnp.moveaxis(frames["of_q"], 0, 1),
        "rf": jnp.moveaxis(frames["rf_m"], 0, 1),
        "yaw": jnp.moveaxis(jnp.deg2rad(frames["yaw_deg"]), 0, 1),
    }

    def step(carry, f):
        st, xc = carry
        st, diag = ekf_step(st, f["dt"], f["rx"], f["ry"], f["q"], f["rf"],
                            f["yaw"], cfg.ekf)
        out = {"mean": st.mean, "flow_used": diag["flow_used"]}
        if extra is not None:
            xc, xout = extra[1](xc, st.mean, f)
            out.update(xout)
        return (st, xc), out

    xc0 = None if extra is None else extra[0]
    # unroll amortizes the per-iteration loop overhead of the tiny
    # [B, 8, 8] step body (MQS_EKF_UNROLL for A/B)
    import os
    _unroll = int(os.environ.get("MQS_EKF_UNROLL", "8"))
    (state, _), outs = lax.scan(step, (state0, xc0), seq, unroll=_unroll)
    track = {
        "x": jnp.moveaxis(outs["mean"][..., 0], 0, 1),
        "y": jnp.moveaxis(outs["mean"][..., 1], 0, 1),
        "vx": jnp.moveaxis(outs["mean"][..., 2], 0, 1),
        "vy": jnp.moveaxis(outs["mean"][..., 3], 0, 1),
        "z": jnp.moveaxis(outs["mean"][..., 4], 0, 1),
        "vz": jnp.moveaxis(outs["mean"][..., 5], 0, 1),
        "yaw": jnp.moveaxis(outs["mean"][..., 6], 0, 1),
        "flow_used": jnp.moveaxis(outs["flow_used"], 0, 1),
    }
    for k in outs:
        if k not in ("mean", "flow_used"):   # extra-hook outputs
            track[k] = jnp.moveaxis(outs[k], 0, 1)
    return state, track


@partial(jax.jit, static_argnums=(1,))
def replay_fusion_batched(frames: dict, cfg: PipelineConfig = UL_PROFILE):
    return _ekf_replay_batched(frames, cfg)


@partial(jax.jit, static_argnums=(1,))
def replay_fusion(frames: dict, cfg: PipelineConfig = UL_PROFILE):
    """Single flight: frames [T] arrays."""
    state, track = _ekf_replay_batched({k: v[None] for k, v in frames.items()}, cfg)
    return (
        EkfState(state.mean[0], state.cov[0]),
        {k: v[0] for k, v in track.items()},
    )


def pose_rmse(track: dict, frames: dict) -> float:
    """RMSE (m) of the recomputed track vs the logged pose, over frames
    where the logged pose is finite."""
    x = np.asarray(frames["x_m"], np.float64)
    y = np.asarray(frames["y_m"], np.float64)
    ok = np.isfinite(x) & np.isfinite(y)
    ex = np.asarray(track["x"], np.float64) - x
    ey = np.asarray(track["y"], np.float64) - y
    if not ok.any():
        return float("nan")
    return float(np.sqrt(np.mean(ex[ok] ** 2 + ey[ok] ** 2)))
