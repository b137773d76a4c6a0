"""Sweep SLAM cost-structure knobs: accuracy (fig-8 drift suite bars:
tail err <= 5 cm, wall IoU >= 0.85 at 12% flow bias) vs throughput
(B=128/T=256 benchmark workload) per candidate configuration.  Run it
on the accelerator whose throughput is to be traded.

The knobs under test cut REDUNDANT work: loop_refine_early (refines in non-final outer rounds),
gn_refine_iters (warm-started refine solves), match_iters_later
(pass-1 iterations in rounds >= 2).

usage: tune_slam_cost.py [quick|full]
"""
import dataclasses
import sys
import time

import numpy as np
import jax

from micro_quad_slam_tpu.ops.raycast import DEFAULT_GEOM, logical_grid
from micro_quad_slam_tpu.replay.fusion import fusion_arrays
from micro_quad_slam_tpu.replay.mapping import scanlog_to_arrays
from micro_quad_slam_tpu.sim import synth_room_scanlog
from micro_quad_slam_tpu.slam.pipeline import slam_replay
from micro_quad_slam_tpu.utils.config import UL_PROFILE
from micro_quad_slam_tpu.utils.obs import map_iou_vs_walls


def vary(prof, **kw):
    return dataclasses.replace(
        prof, slam=dataclasses.replace(prof.slam, **kw))


ROOM = (-2.5, -2.5, 2.5, 2.5)


def fig8_frames(drift):
    log = synth_room_scanlog(n_frames=160, path="fig8", path_radius_m=1.4,
                             room=ROOM, with_flow=True, seed=5)
    log.of_rate_x[:] *= drift
    log.of_rate_y[:] *= drift
    f = {**scanlog_to_arrays(log), **fusion_arrays(log)}
    truth = np.stack([log.x_m, log.y_m], -1)
    return {k: v[None] for k, v in f.items()}, truth


def accuracy(prof, frames, truth):
    res = slam_replay(frames, prof, DEFAULT_GEOM, 10, 8)
    err = np.hypot(*(np.asarray(res.track)[0, :, :2] - truth).T)
    g = np.asarray(logical_grid(res.grid))[0]
    iou = map_iou_vs_walls(g, float(res.origin[0][0]),
                           float(res.origin[1][0]), ROOM)
    return float(err[-20:].mean()), float(iou)


def bench_frames(B, T):
    from micro_quad_slam_tpu.sim import slam_bench_frames
    return slam_bench_frames(B, T)


def throughput(prof, bd, B, T, reps=3):
    res = slam_replay(bd, prof)
    jax.block_until_ready(res.grid)
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        res = slam_replay(bd, prof)
        jax.block_until_ready(res.grid)
        best = min(best, time.time() - t0)
    return B * T / best, best


CANDS = [
    ("r4-default", {}),
    ("early1-warm2-it1", {"loop_refine_early": 1, "gn_refine_iters": 2,
                          "match_iters_later": 1}),
]


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "quick"
    print("backend:", jax.devices()[0].platform, flush=True)
    drifts = (1.12,) if mode == "quick" else (1.0, 1.06, 1.12)
    figs = [(d,) + fig8_frames(d) for d in drifts]
    B, T = 128, 256
    bd = bench_frames(B, T)

    for name, kw in CANDS:
        prof = vary(UL_PROFILE, **kw)
        accs = []
        for d, frames, truth in figs:
            err, iou = accuracy(prof, frames, truth)
            accs.append(f"d{d:.2f}: {err*100:.2f}cm/{iou:.3f}")
        fps, dt = throughput(prof, bd, B, T)
        print(f"{name:28s} {fps/1e3:7.1f} K fps ({dt*1e3:6.1f} ms)  "
              + "  ".join(accs), flush=True)


if __name__ == "__main__":
    main()
