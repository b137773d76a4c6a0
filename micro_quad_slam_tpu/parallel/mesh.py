"""Mesh / sharding layer: scale-out over flight logs.

The reference's "distribution" is four heterogeneous processors on
point-to-point UARTs (SURVEY.md §2F); those links are replayed from logs,
not re-implemented.  The rebuild's parallelism is pure data parallelism
over independent replays (one virtual quad per batch lane), sharded over
a 1-D `('logs',)` device mesh with `NamedSharding` — XLA inserts the
collectives (NCCL all-reduces over NVLink on GPUs) only for the
aggregate metrics.  No TP/PP analog exists or is needed: each
replay's state (pose, 400 KB padded grid, filters) is tiny and strictly
sequential in time; throughput comes from batching, exactly like the
driver's north-star configs (BASELINE.md: 256-4096 logs per chip).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM, GridGeom
from micro_quad_slam_tpu.replay.mapping import _replay_batched
from micro_quad_slam_tpu.utils.config import PipelineConfig, UL_PROFILE

LOGS_AXIS = "logs"


def make_mesh(n_devices: Optional[int] = None, axis: str = LOGS_AXIS) -> Mesh:
    """1-D device mesh over the logs (data-parallel) axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_batch(frames: dict, mesh: Mesh, axis: str = LOGS_AXIS) -> dict:
    """Place a [B, T, ...] frame batch (host or device arrays) with B
    sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return {k: jax.device_put(v, sharding) for k, v in frames.items()}


def batch_metrics(outs: dict) -> dict:
    """Aggregate per-frame outputs to global scalars.  Under a sharded jit
    these sums lower to XLA all-reduces across the mesh."""
    used = outs["used"]
    return {
        "frames_total": jnp.int32(used.size),
        "frames_used": used.sum().astype(jnp.int32),
        "recenters": (outs["kf_flags"] != 0).sum().astype(jnp.int32),
    }


@partial(jax.jit, static_argnums=(1, 2, 3))
def _replay_batched_with_metrics(frames, cfg: PipelineConfig, geom: GridGeom,
                                 kernel: str = "xla"):
    state, outs = _replay_batched(frames, cfg, geom, kernel)
    return state, outs, batch_metrics(outs)


def replay_mapping_sharded(
    frames: dict,
    cfg: PipelineConfig = UL_PROFILE,
    mesh: Optional[Mesh] = None,
    geom: GridGeom = DEFAULT_GEOM,
    kernel: str = "xla",
):
    """Batched replay with the batch sharded across the device mesh.

    frames: dict of [B, T, ...] arrays (host or device).  B should be a
    multiple of the mesh size.  Returns (MappingState [B,...], outs,
    metrics) with per-flight grids left device-sharded and metrics
    all-reduced to replicated scalars.  Every kernel partitions under
    plain GSPMD.
    """
    mesh = mesh or make_mesh()
    frames = shard_batch(frames, mesh)
    return _replay_batched_with_metrics(frames, cfg, geom, kernel)


def shard_pytree(tree, batch: int, mesh: Mesh, axis: str = LOGS_AXIS,
                 replicate_names: tuple = ("key", "t_ms", "scan_count",
                                           "cam_valid")):
    """Place a pytree on the mesh: leaves with a leading dim == batch are
    sharded over the logs axis, everything else (scalars, shared
    constants, RNG keys) is replicated.

    `replicate_names`: leaf field names (NamedTuple attribute / dict key,
    the last path component) that are ALWAYS replicated regardless of
    shape — the guard against a non-batch leaf whose leading dim happens
    to equal `batch` (e.g. a raw [2] PRNG key at batch=2, which the
    shape heuristic alone would wrongly shard)."""
    def name_of(path):
        last = path[-1] if path else None
        return (getattr(last, "name", None) or getattr(last, "key", None)
                or str(last))

    def put(path, a):
        a = jnp.asarray(a)
        shard = (a.ndim >= 1 and a.shape[0] == batch
                 and name_of(path) not in replicate_names)
        shd = NamedSharding(mesh, P(axis) if shard else P())
        return jax.device_put(a, shd)
    return jax.tree_util.tree_map_with_path(put, tree)


def replay_fusion_sharded(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                          mesh: Optional[Mesh] = None):
    """EKF fusion replay with the [B, T] batch sharded across the mesh.
    Pure XLA, so plain GSPMD partitioning applies — the computation (and
    every bit of the result) is identical to the unsharded
    replay_fusion_batched (asserted in tests/test_properties_and_parallel
    on an 8-device CPU mesh)."""
    from micro_quad_slam_tpu.replay.fusion import _ekf_replay_batched

    mesh = mesh or make_mesh()
    frames = shard_batch(frames, mesh)
    return jax.jit(partial(_ekf_replay_batched, cfg=cfg))(frames)


def slam_replay_sharded(frames: dict, cfg: PipelineConfig = UL_PROFILE,
                        mesh: Optional[Mesh] = None,
                        geom: GridGeom = DEFAULT_GEOM, kf_every: int = 10,
                        gn_iters: int = 8):
    """Full SLAM pipeline (EKF odometry -> scan match -> pose-graph GN ->
    re-raster) with flights sharded across the mesh.  SLAM is per-flight
    data-parallel, so it runs under `shard_map` — each device executes
    the whole pipeline on its local shard; results are bit-identical to
    the unsharded slam_replay (no RNG, no cross-flight math; asserted in
    tests)."""
    from micro_quad_slam_tpu.slam.pipeline import SlamResult, slam_replay

    mesh = mesh or make_mesh()
    frames = shard_batch(frames, mesh)
    spec = P(LOGS_AXIS)
    # kf_idx is shared across flights (computed identically per shard);
    # everything else is [B]-leading
    out_specs = SlamResult(grid=spec, track=spec, odo_track=spec,
                           kf_idx=P(), kf_nodes=spec, gn_costs=spec,
                           origin=(spec, spec))
    inner = jax.shard_map(
        partial(slam_replay, cfg=cfg, geom=geom, kf_every=kf_every,
                gn_iters=gn_iters),
        mesh=mesh, in_specs=(spec,), out_specs=out_specs, check_vma=False)
    return jax.jit(inner)(frames)


def sim_run_sharded(state, world, n_steps: int,
                    cfg: PipelineConfig = UL_PROFILE,
                    mesh: Optional[Mesh] = None,
                    geom: GridGeom = DEFAULT_GEOM, dt_ms: int = 20,
                    scan_period_ms: int = 100, record: bool = False,
                    vision_flow: bool = False):
    """Closed-loop swarm simulation with the quad batch sharded across
    the mesh.  The simulator is pure XLA (incl. its jax.random noise
    streams), so GSPMD partitioning reproduces the unsharded values
    bit-for-bit — the threefry bits depend on global shapes, which GSPMD
    preserves (asserted in tests on an 8-device CPU mesh).  Scalar state
    (clock, RNG key, scan counter) is replicated."""
    from micro_quad_slam_tpu.models.simulator import sim_run

    mesh = mesh or make_mesh()
    B = state.x.shape[0]
    state = shard_pytree(state, B, mesh)
    world = shard_pytree(world, B, mesh)
    fn = jax.jit(partial(sim_run, n_steps=n_steps, cfg=cfg, geom=geom,
                         dt_ms=dt_ms, scan_period_ms=scan_period_ms,
                         record=record, vision_flow=vision_flow))
    return fn(state, world)
