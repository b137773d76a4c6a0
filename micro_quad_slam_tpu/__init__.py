"""micro_quad_slam_tpu — batched replay / SLAM engine in JAX.

A JAX/XLA framework with the capabilities of the reference
nano-quadcopter GPS-denied localization-and-mapping stack
(exie1122/micro-quad-SLAM).  The reference's C inner loops (ToF beam
extraction, Bresenham ray-casting into an int8 log-odds occupancy grid,
EMA filtering, altitude estimation, flight state machine) are re-expressed
as pure, jittable per-frame step functions — `lax.scan` over flight time,
`vmap` and mesh sharding over flights — plus new capabilities: an explicit
EKF (replacing ArduPilot's onboard EKF3), scan-matching + pose-graph
Gauss-Newton SLAM, pyramidal Lucas-Kanade optical flow, and a synthetic
swarm simulator.

Layout (mirrors SURVEY.md §7 build plan):
  formats/   log & wire formats (scanrec_t, SCAN/CTRL frames, navlog.csv)
  golden/    C-semantics reference model (numpy + native C++ oracle)
  ops/       core kernels: beams, raycast grid update, EKF, scan match, flow
  models/    replay pipeline, SLAM pipeline, simulator (the "model families")
  parallel/  mesh / sharding / pjit helpers
  utils/     config, metrics, checkpointing, profiling
"""

__version__ = "0.1.0"

from micro_quad_slam_tpu.utils.config import (  # noqa: F401
    MapConfig,
    TofConfig,
    GateConfig,
    BatteryConfig,
    BehaviorConfig,
    EkfConfig,
    PipelineConfig,
    UL_PROFILE,
    CL_PROFILE,
)
