from micro_quad_slam_tpu.sim.synthio import (  # noqa: F401
    replay_bench_frames, room_tof_distance, slam_bench_frames,
    synth_room_scanlog)
