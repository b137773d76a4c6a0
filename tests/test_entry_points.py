"""Entry-point contracts that need no run: the map-update kernel names,
the output shapes of the main paths at their full deployment widths
(traced with jax.eval_shape, nothing compiled or allocated), and the
device helpers (compile cache, GPU check)."""

from pathlib import Path

import numpy as np
import jax
import pytest

from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM as GEOM
from micro_quad_slam_tpu.replay.mapping import (KERNELS, mapping_init,
                                                mapping_step,
                                                replay_mapping_batched)
from micro_quad_slam_tpu.sim import replay_bench_frames, slam_bench_frames
from micro_quad_slam_tpu.utils import device
from micro_quad_slam_tpu.utils.config import UL_PROFILE, UL_RT_PROFILE

REPLAY_B, SLAM_B, EKF_B, SWARM_B, T = 1024, 128, 1024, 1024, 256


def _spec(frames: dict, B: int, T: int) -> dict:
    """[B, T, ...] ShapeDtypeStructs with the dtypes of `frames`."""
    return {k: jax.ShapeDtypeStruct((B, T) + v.shape[2:], v.dtype)
            for k, v in frames.items()}


# ------------------------------------------------------- kernel names ---

@pytest.mark.parametrize("kernel", ["pallas", "pallas_db", "resident",
                                    "resident_cone", "residentx", "conex",
                                    "hybridx", "XLA"])
def test_unknown_kernel_raises(kernel):
    frames = replay_bench_frames(1, 2)
    with pytest.raises(ValueError, match="unknown map-update kernel"):
        replay_mapping_batched(frames, UL_PROFILE, GEOM, kernel)
    with pytest.raises(ValueError, match="unknown map-update kernel"):
        mapping_step(mapping_init(1), {k: v[:, 0] for k, v in frames.items()},
                     UL_PROFILE, GEOM, kernel)
    assert kernel not in KERNELS


# ------------------------------------------------ full-width shapes ---

def test_replay_full_width_shapes():
    spec = _spec(replay_bench_frames(1, 2), REPLAY_B, T)
    for kernel in ("xla", "hybrid"):
        st, outs = jax.eval_shape(
            lambda f: replay_mapping_batched(f, UL_PROFILE, GEOM, kernel),
            spec)
        assert st.grid.shape == (REPLAY_B, GEOM.prows, GEOM.pcols)
        assert st.grid.dtype == np.int8
        assert outs["used"].shape == (REPLAY_B, T)


def test_slam_full_width_shapes():
    from micro_quad_slam_tpu.slam import slam_replay

    frames = slam_bench_frames(1, 2, device_put=False)
    for prof, B in ((UL_PROFILE, SLAM_B), (UL_RT_PROFILE, 2 * SLAM_B)):
        res = jax.eval_shape(lambda f: slam_replay(f, prof),
                             _spec(frames, B, T))
        assert res.grid.shape == (B, GEOM.prows, GEOM.pcols)
        assert res.track.shape == (B, T, 3)
        assert res.kf_nodes.shape == (
            B, len(range(0, T, prof.slam.kf_every)), 3)


def test_ekf_full_width_shapes():
    from micro_quad_slam_tpu.replay.fusion import _ekf_replay_batched

    frames = slam_bench_frames(1, 2, device_put=False)
    frames.pop("grid_mm")
    st, track = jax.eval_shape(
        lambda f: _ekf_replay_batched(f, UL_PROFILE), _spec(frames, EKF_B, T))
    assert st.mean.shape == (EKF_B, 8)
    assert track["x"].shape == (EKF_B, T)


def test_swarm_full_width_shapes():
    from micro_quad_slam_tpu.models.simulator import make_world, sim_init, sim_run

    ticks = 1000
    st0, world = jax.eval_shape(lambda: (
        sim_init(SWARM_B, jax.random.PRNGKey(0), spread_m=0.5,
                 airborne=True),
        make_world(SWARM_B, room=(-3.5, -3.5, 3.5, 3.5),
                   obstacles=[(1.5, -0.5, 2.5, 0.5)])))
    st, diag = jax.eval_shape(
        lambda s, w: sim_run(s, w, ticks, UL_PROFILE, dt_ms=1,
                             scan_period_ms=100), st0, world)
    assert st.mapper.grid.shape == (SWARM_B, GEOM.prows, GEOM.pcols)
    assert diag["state"].shape == (ticks, SWARM_B)


# ------------------------------------------------------------ device ---

@pytest.fixture
def cache_dir_config():
    """Restores jax_compilation_cache_dir after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_unset_env_uses_checkout_path(monkeypatch,
                                                    cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parents[1]
    assert device.configure_compile_cache() == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(repo / ".jax_cache")


def test_compile_cache_env_wins(monkeypatch, tmp_path, cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_raises_without_gpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()
