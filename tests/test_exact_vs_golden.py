"""The exact map-update path (kernel "xla") against the golden model on
batched inputs: random prefilled grids with disabled quads, near-saturated
grids, a forced mid-flight recenter, and the CL state enum.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from micro_quad_slam_tpu.golden.model import GoldenMapper, golden_replay_mapping
from micro_quad_slam_tpu.ops import apply_scan_to_grid, logical_grid
from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM as GEOM
from micro_quad_slam_tpu.replay.mapping import (replay_mapping_batched,
                                                scanlog_to_arrays)
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.utils.config import CL_PROFILE, UL_PROFILE

F32 = np.float32
CFG = UL_PROFILE.map


def _batched_update(padded, beams, xs, ys, yaws, en):
    """One vmapped exact update of a [B] grid batch, origins at 0."""
    return np.asarray(logical_grid(jax.jit(jax.vmap(
        lambda g, b, x, y, w, e: apply_scan_to_grid(
            g, b, x, y, w, F32(0), F32(0), e, CFG)
    ))(jnp.asarray(padded), jnp.asarray(beams), jnp.asarray(xs),
       jnp.asarray(ys), jnp.asarray(yaws), jnp.asarray(en))))


def _golden_update(grid, beams, x, y, yaw, enabled):
    m = GoldenMapper(CFG)
    m.init_map(0.0, 0.0)
    m.grid[:] = grid
    if enabled:
        m.map_update_from_beams(beams, x, y, yaw)
    return m.grid


def _padded(logical):
    B = logical.shape[0]
    padded = np.zeros((B, GEOM.prows, GEOM.pcols), np.int8)
    padded[:, GEOM.pad:GEOM.pad + 500, GEOM.pad:GEOM.pad + 500] = logical
    return padded


@pytest.mark.parametrize("seed", range(3))
def test_batched_update_matches_golden(seed):
    rng = np.random.default_rng(seed)
    B = 3
    logical = rng.integers(-80, 81, size=(B, 500, 500)).astype(np.int8)
    beams = rng.uniform(0.03, 4.2, size=(B, 4, 8)).astype(np.float32)
    beams[rng.random((B, 4, 8)) < 0.1] = np.nan
    xs = rng.uniform(-20, 20, B).astype(np.float32)
    ys = rng.uniform(-20, 20, B).astype(np.float32)
    yaws = rng.uniform(-180, 180, B).astype(np.float32)
    en = rng.random(B) > 0.2
    got = _batched_update(_padded(logical), beams, xs, ys, yaws, en)
    for b in range(B):
        want = _golden_update(logical[b], beams[b], xs[b], ys[b], yaws[b],
                              en[b])
        np.testing.assert_array_equal(got[b], want, err_msg=f"quad {b}")


def test_batched_update_near_saturation_matches_golden():
    """Near-saturated cells make the clamp ORDER observable."""
    rng = np.random.default_rng(9)
    B = 2
    logical = rng.choice(np.array([-80, -79, 78, 79, 80], np.int8),
                         size=(B, 500, 500))
    beams = rng.uniform(0.1, 1.2, size=(B, 4, 8)).astype(np.float32)
    zero = np.zeros(B, np.float32)
    got = _batched_update(_padded(logical), beams, zero, zero, zero,
                          np.ones(B, bool))
    for b in range(B):
        want = _golden_update(logical[b], beams[b], 0.0, 0.0, 0.0, True)
        np.testing.assert_array_equal(got[b], want, err_msg=f"quad {b}")


def _check_replay_vs_golden(logs, cfg, **golden_kw):
    frames = [scanlog_to_arrays(lg) for lg in logs]
    batched = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    st, outs = replay_mapping_batched(batched, cfg, kernel="xla")
    grids = np.asarray(logical_grid(st.grid))
    for b, lg in enumerate(logs):
        mapper, used = golden_replay_mapping(lg, **golden_kw)
        np.testing.assert_array_equal(grids[b], mapper.grid,
                                      err_msg=f"flight {b}")
        np.testing.assert_array_equal(np.asarray(outs["used"])[b], used)
    return outs


def test_replay_forced_recenter_matches_golden():
    """Flight 1 drifts 34 m east and 21 m south in 16 frames, so the
    recenter branch fires mid-flight in the batched replay."""
    logs = [synth_room_scanlog(n_frames=16, seed=3, noise_mm=5.0,
                               dropout_p=0.05),
            synth_room_scanlog(n_frames=16, seed=7, noise_mm=4.0)]
    logs[1].x_m[:] = np.linspace(0.0, 34.0, 16, dtype=np.float32)
    logs[1].y_m[:] = np.linspace(0.0, -21.0, 16, dtype=np.float32)
    outs = _check_replay_vs_golden(logs, UL_PROFILE)
    assert (np.asarray(outs["kf_flags"])[1] != 0).sum() >= 1


def test_replay_cl_state_enum_matches_golden():
    """CL logs number HOVER, LANDING = 5, 6: a CL-profile replay of a
    LANDING-state log maps exactly like the golden model given the CL
    airborne states and flow gate."""
    log = synth_room_scanlog(n_frames=12, seed=31, noise_mm=4.0, state=6)
    outs = _check_replay_vs_golden(
        [log, log], CL_PROFILE, airborne_states=(5, 6),
        of_min_quality=CL_PROFILE.gates.of_min_quality)
    assert np.asarray(outs["used"]).any()
