"""Frozen configuration for the whole pipeline.

All defaults reproduce the reference constants so that "bit-match mode" is
just the default config.  Two profiles exist, mirroring the two revisions of
the reference companion binary:

  * UL_PROFILE — full system (`uav_local_nav.c`): mapping + frontier
    exploration + autonomous turning.
  * CL_PROFILE — stability/demo revision (`clean_uav_fc_tof_nav.c`):
    hover-only, extra diagnostics, defensive altitude estimation.

Every constant cites the reference `file:line` it reproduces.  The dataclasses
are frozen (hashable) so they can be passed as static arguments to `jax.jit`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MapConfig:
    """Log-odds occupancy grid parameters (uav_local_nav.c:182-197)."""

    res_m: float = 0.10          # MAP_RES_M (uav_local_nav.c:182)
    size_m: float = 50.0         # MAP_SIZE_M (uav_local_nav.c:183)
    width: int = 500             # MAP_W (uav_local_nav.c:185)
    height: int = 500            # MAP_H (uav_local_nav.c:186)
    lo_free_dec: int = 1         # LO_FREE_DEC (uav_local_nav.c:194)
    lo_occ_inc: int = 6          # LO_OCC_INC (uav_local_nav.c:195)
    lo_min: int = -80            # LO_MIN (uav_local_nav.c:196)
    lo_max: int = 80             # LO_MAX (uav_local_nav.c:197)
    # Miss-endpoint decrement is LO_FREE_DEC/2 in integer math == 0: a
    # max-range miss leaves the endpoint cell unchanged (uav_local_nav.c:266).
    # Kept explicit so the quirk is visible and testable.
    lo_miss_end_dec: int = 0
    # Recenter when |pose - origin| exceeds 60% of the half-size (= 15 m)
    # (uav_local_nav.c:327-332); shift clamped to +/- half/res*0.5 = 125 cells
    # (uav_local_nav.c:337-341).
    recenter_frac: float = 0.60
    recenter_max_shift_frac: float = 0.50
    # Frontier scoring (uav_local_nav.c:356-385)
    frontier_range_m: float = 2.5
    frontier_step_cells: float = 2.0       # step = MAP_RES_M * 2
    frontier_ray_offsets_deg: tuple = (0.0, 15.0, -15.0)
    frontier_unknown_band: int = 1         # |v| <= 1 -> unknown
    frontier_occ_thresh: int = 10          # v > 10   -> occupied
    frontier_free_thresh: int = -10        # v < -10  -> free
    frontier_w_unknown: int = 3
    frontier_w_free: int = 1
    frontier_w_occ: int = 4

    @property
    def half_m(self) -> float:
        return self.size_m * 0.5

    @property
    def recenter_thresh_m(self) -> float:
        return self.half_m * self.recenter_frac

    @property
    def recenter_max_shift_cells(self) -> int:
        return int(self.half_m / self.res_m * self.recenter_max_shift_frac)

    # Maximum ray length in cells: 4.0 m / 0.10 m = 40 cells along the
    # dominant axis, so a Bresenham walk has at most 41 cells.  The update
    # window (kernel tile) must cover +/- max_ray_cells around the pose.
    @property
    def max_ray_cells(self) -> int:
        return int(round(4.0 / self.res_m))


@dataclass(frozen=True)
class TofConfig:
    """ToF sensor geometry & beam extraction (uav_local_nav.c:104-129,1320-1359)."""

    num_dirs: int = 4
    rows: int = 8
    cols: int = 8
    max_range_m: float = 4.00      # TOF_MAX_RANGE_M (uav_local_nav.c:117)
    fov_deg: float = 63.0          # TOF_FOV_DEG (uav_local_nav.c:118)
    min_valid_m: float = 0.02      # drop returns <= 2 cm (uav_local_nav.c:1329)
    map_skip_below_m: float = 0.05 # mapping skips dist <= 5 cm (uav_local_nav.c:290)
    # hit_occ iff dist < max_range - 0.05 (uav_local_nav.c:292)
    hit_margin_m: float = 0.05
    filt_alpha: float = 0.20       # EMA on per-dir minima (uav_local_nav.c:1431)
    # Direction center angles, yaw-relative, in packet order F,R,B,L
    # (uav_local_nav.c:283)
    dir_center_deg: tuple = (0.0, 90.0, 180.0, -90.0)

    @property
    def half_fov_deg(self) -> float:
        return self.fov_deg * 0.5


@dataclass(frozen=True)
class GateConfig:
    """Freshness / health / stability gating (uav_local_nav.c:900-986)."""

    lpos_fresh_ms: int = 400       # (uav_local_nav.c:936,964)
    of_fresh_ms: int = 400         # (uav_local_nav.c:927)
    rf_fresh_ms: int = 400         # (uav_local_nav.c:1443)
    sys_fresh_ms: int = 1000       # (uav_local_nav.c:901)
    of_min_quality: int = 50       # mapping & XY gates (uav_local_nav.c:943,968);
    #                                clean relaxes to 30 (clean:980,1003)
    xy_min_alt_m: float = 0.12     # (uav_local_nav.c:971)
    xy_stable_hold_ms: int = 1000  # XY_STABLE_HOLD_MS (uav_local_nav.c:956)
    lpos_alt_filt_alpha: float = 0.18  # (uav_local_nav.c:1192)
    alt_clamp_lo_m: float = 0.0    # UL clamps alt to [0, 10] (uav_local_nav.c:1451-1458)
    alt_clamp_hi_m: float = 10.0
    ceil_m: float = 0.70           # CEIL_M (uav_local_nav.c:114); clean 0.90 (clean:104)
    ceil_release_margin_m: float = 0.10  # release at CEIL-0.10 (uav_local_nav.c:1469)
    # Clean-only altitude defenses (clean:1743-1755):
    rf_sanity: bool = False        # reject RF<0.05 while airborne-hinted or |RF-LPOS|>0.8
    rf_sanity_min_m: float = 0.05
    rf_sanity_lpos_delta_m: float = 0.80
    rf_airborne_lpos_m: float = 0.20
    use_alt_max_for_ceiling: bool = False  # clean:1779-1781
    # Clean-only lpos clamp is [-1, 50] instead of [0, 10] (clean:1723-1725,1764-1766)
    lpos_clamp_lo_m: float = 0.0
    lpos_clamp_hi_m: float = 10.0


@dataclass(frozen=True)
class BatteryConfig:
    """2S LiHV battery failsafe (uav_local_nav.c:170-179,1791-1837)."""

    arm_min_vpc: float = 3.70
    land_vpc: float = 3.55
    emerg_vpc: float = 3.35
    low_hold_ms: int = 1200
    fresh_ms: int = 2000
    # Clean validity window and cell inference (clean:939-941,1282-1299)
    # live in the telemetry adapter's intake latch (replay/telemetry.py,
    # fuzz-diffed against the compiled C) — the tick gates on
    # Telemetry.batt_valid, exactly like the C's batt_valid flag.
    # Clean suppresses LAND actions (log only) (clean:2127-2175)
    land_actions_enabled: bool = True


@dataclass(frozen=True)
class BehaviorConfig:
    """Flight state machine / exploration parameters (uav_local_nav.c)."""

    takeoff_target_m: float = 0.50     # (uav_local_nav.c:113); clean 0.35 (clean:103)
    hover_target_m: float = 0.45       # clean-only explicit hover target (clean:102)
    front_stop_m: float = 0.60         # FRONT_STOP_M (uav_local_nav.c:121)
    side_safe_m: float = 0.80          # SIDE_SAFE_M (uav_local_nav.c:122)
    fwd_vel_mps: float = 0.35          # FWD_VEL (uav_local_nav.c:125)
    yaw_rate_dps: float = 20.0         # YAW_RATE_DPS (uav_local_nav.c:129)
    yaw_hold_gain: float = 1.2         # (uav_local_nav.c:864)
    turn_gain: float = 0.8             # (uav_local_nav.c:2283)
    turn_exit_err_deg: float = 6.0     # (uav_local_nav.c:2290)
    turn_timeout_ms: int = 6000        # (uav_local_nav.c:2290)
    frontier_eval_ms: int = 1200       # FRONTIER_EVAL_MS (uav_local_nav.c:232)
    frontier_side_margin: int = 35     # side beats front by >35 (uav_local_nav.c:2239)
    frontier_tof_bias: float = 5.0     # score += dist*5 (uav_local_nav.c:1726-1728)
    post_turn_pause_ms: int = 450      # POST_TURN_PAUSE_MS (uav_local_nav.c:238)
    hover_explore_delay_ms: int = 1200 # (uav_local_nav.c:2199)
    takeoff_no_vel_ms: int = 2000      # (uav_local_nav.c:150); clean 900 (clean:132)
    takeoff_mot_start_us: float = 1150.0
    takeoff_start_check_ms: int = 1500
    takeoff_stall_ms: int = 4500       # (uav_local_nav.c:2156); clean 8000 (clean:135)
    takeoff_retry_ms: int = 3000       # re-issue NAV_TAKEOFF (uav_local_nav.c:2077)
    ramp_send_ms: int = 50             # 20 Hz attitude target (uav_local_nav.c:154)
    ramp_total_ms: int = 1800          # (uav_local_nav.c:155); clean 700
    ramp_abort_ms: int = 2600          # (uav_local_nav.c:156)
    ramp_thr_min: float = 0.15         # (uav_local_nav.c:157); clean 0.50
    ramp_thr_max: float = 0.60         # (uav_local_nav.c:158); clean 0.95
    ramp_exit_m: float = 0.15          # TO_RAMP_EXIT_M (uav_local_nav.c:159)
    assist_thr_us_min: int = 1300      # (uav_local_nav.c:138); clean 1550
    assist_thr_us_max: int = 1600      # (uav_local_nav.c:139); clean 1850
    assist_send_period_ms: int = 50    # (uav_local_nav.c:140); clean 40
    assist_total_ms: int = 1800        # (uav_local_nav.c:141); clean 800
    assist_exit_alt_m: float = 0.28    # (uav_local_nav.c:142)
    assist_abort_ms: int = 2600        # (uav_local_nav.c:143); clean 2000
    assist_override_effect_ms: int = 400
    assist_motor_delta_min: float = 40.0
    landing_descent_mps: float = 0.15  # (uav_local_nav.c:2311)
    landing_near_ground_m: float = 0.10
    ceiling_descend_mps: float = 0.30  # (uav_local_nav.c:2026)
    explore_enabled: bool = True       # clean drops EXPLORE/TURNING
    # UL's one behavior-affecting compile-time toggle (HOVER_TEST_ONLY,
    # uav_local_nav.c:522): `break` out of the HOVER case AFTER hover
    # hold + map init but BEFORE the EXPLORE transition (:2196-2199) —
    # the machine parks in HOVER with EXPLORE/TURNING still compiled in.
    hover_test_only: bool = False
    takeoff_exit_margin_m: float = 0.05  # hover at target-0.05 (uav_local_nav.c:2164)
    hover_capture_min_alt_m: float = 0.15  # clean prelock gate (clean:106)
    prearm_stable_ms: int = 400        # clean:107
    stale_fail_ticks: int = 40         # clean hover sensor-stale hysteresis (clean:416)
    disarm_force_code: float = 21196.0 # (uav_local_nav.c:762)
    thrust_clamp: float = 0.75         # (uav_local_nav.c:824); clean 0.90
    attitude_ramp_sqrt: bool = False   # clean eases thrust with sqrt(u) (clean:2107)


@dataclass(frozen=True)
class SlamConfig:
    """Scan-match + pose-graph SLAM back-end (new capability; slam/).

    The reference dead-reckons on the FC EKF (SURVEY.md §7 step 7); these
    tunables govern the rebuild's drift-correction stack.  Defaults are
    the values the pipeline shipped with in rounds 1-2."""

    kf_every: int = 10             # keyframe cadence (frames)
    # Gauss-Newton iterations (static).  8 -> 5 in round 4: measured
    # IDENTICAL tail error and wall IoU on the fig-8 suite at drifts
    # 1.00/1.06/1.12 for both operating profiles (tools/tune_loop.py
    # A/B; GN converges in <= 5 iterations from odometry-grade guesses),
    # and each iteration adds a batched Cholesky solve to the chain.
    gn_iters: int = 5
    # correlative matcher lattice around the odometry guess (pass 1)
    match_n_xy: int = 7
    match_n_yaw: int = 7
    match_xy_step_m: float = 0.05
    match_yaw_step_deg: float = 1.0
    match_min_quality: float = 3.0  # accept gate: peak-minus-mean per hit
    # Keyframes match against a map SNAPSHOT refreshed every this many
    # keyframe intervals (the classic submap-lag formulation).  >1 lets
    # all of an interval's keyframes match in parallel against one
    # snapshot instead of one after another, at the price of matching
    # against a map that lags by up to (match_chunk_intervals-1)
    # keyframe intervals.
    match_chunk_intervals: int = 4
    # Pass 1 builds its match map from KEYFRAME scans only (the classic
    # keyframe-submap formulation).  The pass-1 grid exists solely to
    # give the correlative matcher something to match against — the
    # output map is re-rastered from ALL frames in pass 3 with the exact
    # reference update semantics — so skipping the 90% of frames between
    # keyframes costs only match-map density (walls accumulate from
    # every keyframe; quality gates in tests/test_slam.py hold) and cuts
    # the pass-1 kernel work ~kf_every-fold.  False restores the
    # rounds-1-2 all-frames match map.
    match_map_kf_only: bool = True
    # Pass 1's match map accumulates keyframe scans at their MATCHED
    # poses (True: the rounds-1-3 feedback formulation — each keyframe's
    # correction lands on the grid later keyframes match against) or at
    # their raw ODOMETRY poses (False: feedback-free).  Feedback-free
    # cuts the match->update->match serial chain: the snapshot grids are
    # producible by a match-free chunk scan and ALL keyframe matches
    # then run as one flat batch.  Only meaningful with
    # match_map_kf_only; accuracy A/B lives in tests/test_slam.py
    # (the corrections stay anchored by pass 2's graph, so the fig-8 /
    # drift suites hold the same error bounds either way).
    match_feedback: bool = False
    # Feedback-free pass-1 rounds of (rebuild the keyframe match map at
    # the current pose estimates -> flat re-match).  Round 1 maps at raw
    # odometry; round i>1 maps at round i-1's matched poses, recovering
    # the accuracy the feedback formulation got from correcting the map
    # as it grew (fig-8 A/B in tests/test_slam.py) while every round
    # stays fully parallel.  Ignored when match_feedback=True.
    match_iters: int = 2
    # revisit loop-closure candidates (pass 1b)
    loop_min_gap: int = 3          # candidate must be >= this many kf older
    loop_r_max_m: float = 1.0      # proximity gate on keyframe distance
    # revisit matcher lattice — pruned vs pass 1: the guess is already
    # odometry-good, so a 5x5x5 lattice holds the same peak as 7x7x7
    loop_n_xy: int = 5
    loop_n_yaw: int = 5
    # pose-graph edge information weights (x, y, theta)
    # loop-edge accept gate, SEPARATE from the pass-1 gate: the loop
    # matcher scores against a single keyframe's endpoint-only field
    # over the pruned loop lattice, where peak-minus-mean runs ~0.8-2.0
    # on genuine revisits — the pass-1 calibration (3.0, dense
    # accumulated map + wider lattice) rejects every real loop edge
    # (found in round 3: loop closure had silently stopped firing).
    loop_min_quality: float = 0.5
    # loop-closure edges per keyframe: each extra edge matches against
    # the NEXT-nearest older candidate under the same gap/radius/quality
    # gates — denser constraints for flights revisiting a place more
    # than once (VERDICT round 2, weak 4 tail).  1 = the rounds-1-3
    # single-edge behavior.  Default 2, measured on the fig-8 suite:
    # tail err 3.06 -> 2.64 cm (drift 1.06) and 11.18 -> 9.93 cm
    # (drift 1.12) vs one edge, at K extra matches per flight.
    loop_edges: int = 2
    # robust loop closure (round 4, VERDICT ask 1):
    # candidates per keyframe actually MATCHED (nearest-older within
    # loop_r_max_m); the loop_edges best BY MATCH QUALITY become edges —
    # quality-ranked selection instead of pure proximity order
    loop_cand: int = 3
    # Huber delta on the information-weighted loop residual norm
    # (posegraph.PoseGraph.edges_huber; 0 disables).  At loop_w=(60,..)
    # a delta of 1.0 soft-limits edges disagreeing by more than ~13 cm.
    loop_huber: float = 1.0
    # loop-edge information scales with match quality:
    # w_e = loop_w * clip(quality / loop_q_ref, loop_q_min, loop_q_max)
    # — a barely-above-gate match carries a fraction of the confidence
    # of a sharp revisit peak
    # (measured on the fig-8 drift suite: scaling below/above full
    # weight cost wall IoU 0.876 -> 0.821 with the full round-4 stack,
    # so the default clip pins scale = 1; the knob stays for field maps
    # with genuinely mixed-quality revisits)
    loop_q_ref: float = 1.5
    loop_q_min: float = 1.0
    loop_q_max: float = 1.0
    # re-match rounds at SOLVED poses: after the Gauss-Newton solve the
    # loop stage runs again with the solved keyframe poses as guesses
    # (better guesses -> matches that failed or mis-peaked at odometry
    # guesses land), and the graph is rebuilt and re-solved.  0 = off.
    loop_refine: int = 3
    # refine rounds in NON-FINAL outer rounds (-1 = same as loop_refine).
    # Round-5 cost work: the early rounds' solves only seed the next
    # round's match-map rebuild, where a coarser solve suffices; the
    # full refine ladder runs once, on the final round.
    loop_refine_early: int = -1
    # GN iterations for refine-round solves (0 = gn_iters).  Refine
    # solves start from the PREVIOUS solution (warm start), so they
    # need fewer iterations than the cold odometry-initialized solve.
    gn_refine_iters: int = 0
    # pass-1 match iterations in outer rounds >= 2 (0 = same as
    # match_iters): round >= 2's `est` is already a loop-consistent
    # solved track, so one re-match against its rebuilt map recovers
    # what two iterations buy from raw odometry.  Like match_iters,
    # this applies to the DEFAULT feedback-free pass 1 only
    # (match_map_kf_only and not match_feedback); the feedback and
    # all-frames formulations have no iteration loop to override.
    match_iters_later: int = 0
    # OUTER global rounds: after a full (pass 1 -> loops -> graph) solve,
    # rebuild the pass-1 match map at the SOLVED track and repeat.  At
    # high drift pass 1 matches against a map distorted by the very
    # drift it is correcting and OVERCORRECTS (measured: 13.5 cm tail vs
    # 11.4 cm raw at 12% flow bias with loops off); a map built at the
    # loop-consistent solved track removes that distortion, so round-2
    # matches pin the mid-track absolute drift the loop edges alone
    # cannot reach.  1 = single-pass (rounds 1-3 behavior).
    slam_outer: int = 3
    # Per-flight odometry SCALE estimation between outer rounds: flow
    # odometry fails with a multiplicative gain error (the reference's
    # own flow-calibration weakness, BASELINE.md), which bends the whole
    # track — loop edges only pin revisit pairs.  After each solve the
    # scale is re-fit by least squares over keyframe step LENGTHS
    # (|solved step| ~ s * |odo step|, rotation-invariant) and applied
    # to the next round's odometry edge measurements and the rigid
    # intra-keyframe-interval composition.  Clipped to [min, max];
    # 1.0/1.0 disables.
    odo_scale_min: float = 0.8
    odo_scale_max: float = 1.25
    odo_w: tuple = (100.0, 100.0, 400.0)
    # round-4 rebalance (measured, tools/tune_loop.py): pass-1 anchors
    # encode the drift-distorted match map and OVERCORRECT at high
    # drift — weak anchors + strong loop edges took the fig-8 @12%
    # suite from 9.93 cm / IoU 0.671 to 2.98 cm / IoU 0.876 (with
    # loop_refine=3, slam_outer=3 and the odometry scale fit)
    anchor_w: tuple = (10.0, 10.0, 40.0)
    loop_w: tuple = (120.0, 120.0, 480.0)
    # recenter the SLAM grid when the pose strays past the map threshold,
    # exactly like the mapping replay (uav_local_nav.c:308-353); the
    # schedule is decided grid-free from the odometry track
    recenter: bool = True


@dataclass(frozen=True)
class EkfConfig:
    """Explicit EKF replacing ArduPilot EKF3 (new capability; the reference
    consumed LOCAL_POSITION_NED, uav_local_nav.c:1168-1195)."""

    # state: [x, y, vx, vy, z, vz, yaw, wz]; flow measures body velocity,
    # the rangefinder measures z, logged attitude measures yaw.
    q_pos: float = 1e-4       # process noise on position (m^2 / step)
    q_vel: float = 0.4        # process noise on velocity
    q_vz: float = 0.4         # process noise on vertical velocity
    q_yaw: float = 1e-4       # process noise on yaw (rad^2 / s)
    q_wz: float = 0.5         # process noise on yaw rate
    r_flow_vel: float = 1e-2  # flow-derived velocity measurement noise
    r_zero_vel: float = 1.0   # weak zero-velocity prior when flow is bad
    r_rf: float = 4e-4        # rangefinder variance (~2 cm sigma)
    r_yaw: float = 3e-4       # attitude-yaw variance (~1 deg sigma)
    min_flow_quality: int = 50
    min_ground_m: float = 0.05


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle; hashable, usable as a jit static argument."""

    map: MapConfig = MapConfig()
    tof: TofConfig = TofConfig()
    gates: GateConfig = GateConfig()
    battery: BatteryConfig = BatteryConfig()
    behavior: BehaviorConfig = BehaviorConfig()
    ekf: EkfConfig = EkfConfig()
    slam: SlamConfig = SlamConfig()
    name: str = "ul"

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# Profile matching uav_local_nav.c (full system).
# Cost restructure (tools/tune_slam_cost.py, B=128/T=256 with the fig-8
# drift suite): full refine ladders in every outer round were redundant —
# early rounds' solves only seed the next round's match-map rebuild.  One
# early refine + warm-started 2-iter refine solves + single pass-1
# re-match in rounds >= 2 cut the work while IMPROVING the barred
# d=1.12 point (2.29 cm/IoU 0.853 -> 2.18 cm/0.864; bars: <= 5 cm,
# >= 0.85).
UL_PROFILE = PipelineConfig(name="ul", slam=SlamConfig(
    loop_refine_early=1, gn_refine_iters=2, match_iters_later=1))

# Throughput operating point for the SLAM back-end: ONE global round,
# no post-solve re-match rounds, ONE pass-1 match iteration, two loop
# candidates per keyframe.  Same pass-1 matcher, loop closure, Huber
# graph and exact pass-3 re-raster as the accuracy defaults — only the
# round-4 accuracy multipliers (slam_outer=3, loop_refine=3,
# match_iters=2, loop_cand=3, whose value is drift-correction quality
# at 10-12% flow-gain error) are dialed back to the
# single-pass formulation.  match_iters=1 is not even a trade at this
# operating point: with a single global round the second match
# iteration's map-rebuild feedback OVERCORRECTS (the same mechanism
# the accuracy profile fixes with outer rounds) — measured fig-8
# drift 1.00: 2.73 cm/IoU 0.952 -> 1.17 cm/1.000, 1.06: 3.13/0.844 ->
# 2.02/0.905 (tools/tune_loop.py).  Use for throughput-bound replay
# fleets at low-to-moderate drift; high-drift flights want UL_PROFILE.
UL_RT_PROFILE = UL_PROFILE.replace(
    name="ul-rt", slam=SlamConfig(slam_outer=1, loop_refine=0,
                                  match_iters=1, loop_cand=2))

# Profile matching clean_uav_fc_tof_nav.c (hover-only stability revision).
CL_PROFILE = PipelineConfig(
    name="cl",
    gates=GateConfig(
        of_min_quality=30,            # clean:980,1003
        ceil_m=0.90,                  # clean:104
        rf_sanity=True,               # clean:1743-1755
        use_alt_max_for_ceiling=True, # clean:1779-1781
        lpos_clamp_lo_m=-1.0,         # clean:1723-1725
        lpos_clamp_hi_m=50.0,
    ),
    battery=BatteryConfig(land_actions_enabled=False),  # clean:2127-2175
    behavior=BehaviorConfig(
        takeoff_target_m=0.35,        # clean:103
        takeoff_no_vel_ms=900,        # clean:132
        takeoff_stall_ms=8000,        # clean:135
        ramp_total_ms=700,            # clean:2098-2119
        ramp_thr_min=0.50,
        ramp_thr_max=0.95,
        assist_thr_us_min=1550,       # clean:121
        assist_thr_us_max=1850,
        assist_send_period_ms=40,
        assist_total_ms=800,
        assist_abort_ms=2000,
        assist_override_effect_ms=250,
        assist_motor_delta_min=15.0,
        explore_enabled=False,
        thrust_clamp=0.90,
        attitude_ramp_sqrt=True,
    ),
)
