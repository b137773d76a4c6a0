"""Pyramidal Lucas-Kanade optical flow on downward-camera frames
(BASELINE.json config 3 — a new capability: the reference CONSUMED flow
telemetry computed by an external sensor, uav_local_nav.c:1125-1166; this
module computes it from pixels, on-device, batched over quads).

Estimates the single global image shift of a downward-looking camera
(the PX4FLOW/PMW3901 operating model): coarse-to-fine over an L-level
mean-pool pyramid; at each level a few Gauss-Newton iterations solve the
2x2 LK normal equations over the whole frame with a bilinear warp.  All
ops are dense elementwise/reduction work (VPU) with static shapes; vmap
gives per-quad flow for the whole swarm.

Conversions follow the reference's convention: flow_rate [rad/s] =
pixel_shift / focal_px / dt, and velocity = rate * ground_distance
(uav_local_nav.c:1150-1165).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

_F32 = np.float32


def _pool2(img):
    """2x2 mean pool (pyramid downsample)."""
    H, W = img.shape[-2:]
    x = img.reshape(img.shape[:-2] + (H // 2, 2, W // 2, 2))
    return x.mean(axis=(-1, -3))


def _bilinear_shift(img, dx, dy):
    """Sample img at (x + dx, y + dy) with bilinear interpolation and
    zero-gradient (clamped) borders.  dx, dy are scalars (traced).

    The shift is separable and global, so it is two tiny one-hot-banded
    MATMULS (row mix @ img @ column mix) instead of a batched gather with
    traced indices.  The one-hot
    selectors encode the same index clamping as the gather version;
    HIGHEST precision keeps the interpolation weights at full f32."""
    H, W = img.shape[-2:]
    x0 = jnp.floor(dx)
    y0 = jnp.floor(dy)
    ax = dx - x0
    ay = dy - y0
    ix = x0.astype(jnp.int32)
    iy = y0.astype(jnp.int32)

    col_o = jnp.arange(W)
    col_i = col_o[:, None]
    s0 = jnp.clip(col_o + ix, 0, W - 1)[None, :]
    s1 = jnp.clip(col_o + ix + 1, 0, W - 1)[None, :]
    cx = ((col_i == s0) * (1 - ax) + (col_i == s1) * ax)     # [W_in, W_out]

    row_o = jnp.arange(H)[:, None]
    r0 = jnp.clip(jnp.arange(H) + iy, 0, H - 1)[:, None]
    r1 = jnp.clip(jnp.arange(H) + iy + 1, 0, H - 1)[:, None]
    row_i = jnp.arange(H)[None, :]
    ry = ((r0 == row_i) * (1 - ay) + (r1 == row_i) * ay)     # [H_out, H_in]

    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul(ry, jnp.matmul(img, cx, precision=hp), precision=hp)


def _lk_level(prev, curr, dx, dy, iters: int, eps: float = 1e-6):
    """Refine (dx, dy) at one pyramid level with GN iterations.
    Border pixels are excluded from the normal equations (warp clamping
    pollutes them)."""
    H, W = prev.shape[-2:]
    gy, gx = jnp.gradient(prev)
    m = jnp.zeros((H, W), jnp.float32).at[2:-2, 2:-2].set(1.0)
    gxx = (gx * gx * m).sum()
    gxy = (gx * gy * m).sum()
    gyy = (gy * gy * m).sum()
    det = gxx * gyy - gxy * gxy

    def body(_, c):
        dx, dy = c
        warped = _bilinear_shift(curr, dx, dy)
        it = (warped - prev) * m
        bx = (gx * it).sum()
        by = (gy * it).sum()
        sx = jnp.where(det > eps, (gyy * bx - gxy * by) / (det + eps), 0.0)
        sy = jnp.where(det > eps, (gxx * by - gxy * bx) / (det + eps), 0.0)
        return dx - sx, dy - sy

    return jax.lax.fori_loop(0, iters, body, (dx, dy))


class FlowResult(NamedTuple):
    dx_px: jnp.ndarray      # image shift (pixels, +x right)
    dy_px: jnp.ndarray
    quality: jnp.ndarray    # 0-255 confidence from residual + texture


def lk_flow(prev: jnp.ndarray, curr: jnp.ndarray, levels: int = 3,
            iters: int = 4) -> FlowResult:
    """Global pyramidal LK shift between two [H, W] float frames.
    H, W must be divisible by 2**(levels-1)."""
    prev = prev.astype(jnp.float32)
    curr = curr.astype(jnp.float32)
    pyr = [(prev, curr)]
    for _ in range(levels - 1):
        p, c = pyr[-1]
        pyr.append((_pool2(p), _pool2(c)))

    dx = jnp.float32(0.0)
    dy = jnp.float32(0.0)
    for p, c in reversed(pyr):
        dx = dx * 2.0
        dy = dy * 2.0
        dx, dy = _lk_level(p, c, dx, dy, iters)

    # confidence: normalized residual after alignment + texture strength
    warped = _bilinear_shift(curr, dx, dy)
    resid = jnp.abs(warped - prev)[2:-2, 2:-2].mean()
    contrast = jnp.abs(prev - prev.mean())[2:-2, 2:-2].mean()
    q = jnp.clip(255.0 * (1.0 - resid / (contrast + 1e-3)), 0.0, 255.0)
    q = jnp.where(contrast < 1e-3, 0.0, q)
    # the GN solves for the warp aligning curr to prev (= -scene shift);
    # negate to report CAMERA motion in pixels, the PX4FLOW convention.
    return FlowResult(-dx, -dy, q)


lk_flow_batched = jax.vmap(lk_flow, in_axes=(0, 0))


def flow_to_rates(dx_px, dy_px, dt_s, focal_px: float):
    """Pixel shift -> angular rates [rad/s] (small-angle model, the same
    quantity OPTICAL_FLOW_RAD integrates, uav_local_nav.c:1150-1157)."""
    return dx_px / (_F32(focal_px) * dt_s), dy_px / (_F32(focal_px) * dt_s)


def rates_to_velocity(rate_x, rate_y, ground_m):
    """Angular rates + ground distance -> body-frame velocity [m/s]
    (reference displacement convention, uav_local_nav.c:1159-1165)."""
    return rate_x * ground_m, rate_y * ground_m


# ----------------------------- test support -------------------------------

def render_ground_patch(texture: jnp.ndarray, cx, cy, size: int,
                        scale: float = 1.0):
    """Render a size x size camera view of a big ground texture centered at
    (cx, cy) texture pixels (bilinear).  Used by tests and the simulator to
    generate downward-camera frames from quad motion."""
    half = (size - 1) / 2.0
    ys = cy + (jnp.arange(size) - half) * scale
    xs = cx + (jnp.arange(size) - half) * scale
    y0 = jnp.floor(ys).astype(jnp.int32)
    x0 = jnp.floor(xs).astype(jnp.int32)
    ay = (ys - y0)[:, None]
    ax = (xs - x0)[None, :]
    H, W = texture.shape

    def take(oy, ox):
        yy = jnp.clip(y0 + oy, 0, H - 1)
        xx = jnp.clip(x0 + ox, 0, W - 1)
        return texture[yy[:, None], xx[None, :]]

    return ((1 - ay) * (1 - ax) * take(0, 0) + (1 - ay) * ax * take(0, 1)
            + ay * (1 - ax) * take(1, 0) + ay * ax * take(1, 1))


def analytic_ground(px, py):
    """Procedural ground texture: a fixed sum of sinusoids evaluated at
    world-plane coordinates (meters).  Pure elementwise math — no texture
    gathers — so the simulator can render downward-camera frames for the
    whole swarm cheaply.  Rich enough in gradients for LK at sub-pixel
    accuracy."""
    v = (jnp.sin(px * 9.1) * jnp.cos(py * 7.3)
         + 0.7 * jnp.sin(px * 23.7 + py * 31.1)
         + 0.5 * jnp.cos(px * 41.3 - py * 17.9)
         + 0.3 * jnp.sin(px * 73.0 + 2.0) * jnp.sin(py * 61.0))
    return _F32(100.0) + _F32(30.0) * v


def render_camera_frame(x_m, y_m, alt_m, yaw_rad, size: int,
                        focal_px: float):
    """Downward camera view of the analytic ground from pose
    (x, y, alt, yaw): pixel (r, c) sees the ground at
    pos + R(yaw) @ (u, v) * alt / focal."""
    half = (size - 1) / 2.0
    u = (jnp.arange(size, dtype=jnp.float32) - _F32(half))  # cam x (cols)
    v = (jnp.arange(size, dtype=jnp.float32) - _F32(half))  # cam y (rows)
    scale = alt_m / _F32(focal_px)
    cu = u[None, :] * scale
    cv = v[:, None] * scale
    c, s = jnp.cos(yaw_rad), jnp.sin(yaw_rad)
    px = x_m + c * cu - s * cv
    py = y_m + s * cu + c * cv
    return analytic_ground(px, py)
