"""scanlog.bin codec — the replay input format of the whole framework.

The reference logs one packed 569-byte record per accepted ToF scan
(`scanrec_t`, uav_local_nav.c:1522-1547) into `/mnt/sdcard/scanlog.bin`,
after a one-time 7-byte file header "SCLOG2\\n" (uav_local_nav.c:1505).
Each record carries the full sensor + pose snapshot needed for deterministic
offline reproduction: dual timestamps (host + sensor clock,
uav_local_nav.c:1362-1364), EKF pose, attitude, rangefinder, optical-flow
rates/quality, behavior state, keyframe flags (uav_local_nav.c:218-229), FC
health bits, and the raw 512-byte 4x8x8 u16le ToF grid in physical order
FRONT, RIGHT, BACK, LEFT.

This module reads/writes that exact byte layout with numpy structured
arrays (zero-copy `np.frombuffer`), and converts to/from the struct-of-
arrays layout the device pipeline consumes.
"""

from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Union

import numpy as np

SCANLOG_FILE_HEADER = b"SCLOG2\n"
SCANREC_MAGIC = 0x324E4353  # 'SCN2' little-endian (uav_local_nav.c:1555)
SCANREC_BYTES = 569

# Packed little-endian layout of scanrec_t (uav_local_nav.c:1522-1547):
# 57-byte header followed by the raw 512-byte grid.
SCANREC_DTYPE = np.dtype(
    [
        ("magic", "<u4"),
        ("host_ms", "<u4"),
        ("scan_ms", "<u4"),
        ("x_m", "<f4"),
        ("y_m", "<f4"),
        ("yaw_deg", "<f4"),
        ("alt_m", "<f4"),
        ("roll_rad", "<f4"),
        ("pitch_rad", "<f4"),
        ("rf_m", "<f4"),
        ("of_rate_x", "<f4"),
        ("of_rate_y", "<f4"),
        ("of_q", "u1"),
        ("state", "u1"),
        ("kf_flags", "u1"),
        ("_pad0", "<u2"),
        ("sys_health", "<u4"),
        ("grid_raw", "u1", (512,)),
    ]
)
assert SCANREC_DTYPE.itemsize == SCANREC_BYTES

# Keyframe flag bits (uav_local_nav.c:218-229)
KF_TAKEOFF = 1 << 0
KF_TURN_START = 1 << 1
KF_TURN_END = 1 << 2
KF_LAND_START = 1 << 3
KF_LIFTOFF_AST = 1 << 4
KF_MAP_RECENTER = 1 << 5
KF_BATT_LAND = 1 << 6
KF_BATT_EMERG = 1 << 7


@dataclasses.dataclass
class ScanLog:
    """Struct-of-arrays view of a scanlog: T records, ready for the device.

    `grid_mm` is decoded to u16 [T, 4, 8, 8] (dir order F,R,B,L; row-major
    8x8 per sensor, already orientation-normalized by the hub —
    tof_esp32.ino:98-101,200-209).
    """

    host_ms: np.ndarray      # u32 [T]
    scan_ms: np.ndarray      # u32 [T]
    x_m: np.ndarray          # f32 [T]
    y_m: np.ndarray          # f32 [T]
    yaw_deg: np.ndarray      # f32 [T]
    alt_m: np.ndarray        # f32 [T]
    roll_rad: np.ndarray     # f32 [T]
    pitch_rad: np.ndarray    # f32 [T]
    rf_m: np.ndarray         # f32 [T]
    of_rate_x: np.ndarray    # f32 [T]
    of_rate_y: np.ndarray    # f32 [T]
    of_q: np.ndarray         # u8  [T]
    state: np.ndarray        # u8  [T]
    kf_flags: np.ndarray     # u8  [T]
    sys_health: np.ndarray   # u32 [T]
    grid_mm: np.ndarray      # u16 [T, 4, 8, 8]

    def __len__(self) -> int:
        return int(self.host_ms.shape[0])

    @classmethod
    def from_records(cls, rec: np.ndarray) -> "ScanLog":
        grid = rec["grid_raw"].view("<u2").reshape(-1, 4, 8, 8)
        return cls(
            host_ms=np.ascontiguousarray(rec["host_ms"]),
            scan_ms=np.ascontiguousarray(rec["scan_ms"]),
            x_m=np.ascontiguousarray(rec["x_m"]),
            y_m=np.ascontiguousarray(rec["y_m"]),
            yaw_deg=np.ascontiguousarray(rec["yaw_deg"]),
            alt_m=np.ascontiguousarray(rec["alt_m"]),
            roll_rad=np.ascontiguousarray(rec["roll_rad"]),
            pitch_rad=np.ascontiguousarray(rec["pitch_rad"]),
            rf_m=np.ascontiguousarray(rec["rf_m"]),
            of_rate_x=np.ascontiguousarray(rec["of_rate_x"]),
            of_rate_y=np.ascontiguousarray(rec["of_rate_y"]),
            of_q=np.ascontiguousarray(rec["of_q"]),
            state=np.ascontiguousarray(rec["state"]),
            kf_flags=np.ascontiguousarray(rec["kf_flags"]),
            sys_health=np.ascontiguousarray(rec["sys_health"]),
            grid_mm=np.ascontiguousarray(grid),
        )

    def to_records(self) -> np.ndarray:
        T = len(self)
        rec = np.zeros(T, dtype=SCANREC_DTYPE)
        rec["magic"] = SCANREC_MAGIC
        rec["host_ms"] = self.host_ms
        rec["scan_ms"] = self.scan_ms
        rec["x_m"] = self.x_m
        rec["y_m"] = self.y_m
        rec["yaw_deg"] = self.yaw_deg
        rec["alt_m"] = self.alt_m
        rec["roll_rad"] = self.roll_rad
        rec["pitch_rad"] = self.pitch_rad
        rec["rf_m"] = self.rf_m
        rec["of_rate_x"] = self.of_rate_x
        rec["of_rate_y"] = self.of_rate_y
        rec["of_q"] = self.of_q
        rec["state"] = self.state
        rec["kf_flags"] = self.kf_flags
        rec["sys_health"] = self.sys_health
        rec["grid_raw"] = (
            np.ascontiguousarray(self.grid_mm, dtype="<u2")
            .reshape(T, 256)
            .view("u1")
            .reshape(T, 512)
        )
        return rec


def read_scanlog(src: Union[str, bytes, BinaryIO], strict: bool = True) -> ScanLog:
    """Read a scanlog.bin file / buffer into a ScanLog.

    Mirrors the reference writer's append-mode behavior: the 7-byte
    "SCLOG2\\n" header appears only at file start (uav_local_nav.c:1498-1508);
    records follow back-to-back.  With strict=False, trailing partial records
    are dropped and records with a bad magic are skipped (resync by record
    stride is sufficient because the writer is record-aligned).
    """
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        data = src.read()

    if data[: len(SCANLOG_FILE_HEADER)] == SCANLOG_FILE_HEADER:
        data = data[len(SCANLOG_FILE_HEADER):]

    n_full = len(data) // SCANREC_BYTES
    if strict and len(data) % SCANREC_BYTES != 0:
        raise ValueError(
            f"scanlog payload of {len(data)} bytes is not a multiple of "
            f"{SCANREC_BYTES}-byte records"
        )
    rec = np.frombuffer(data[: n_full * SCANREC_BYTES], dtype=SCANREC_DTYPE)
    bad = rec["magic"] != SCANREC_MAGIC
    if bad.any():
        if strict:
            raise ValueError(f"{int(bad.sum())}/{len(rec)} records have bad magic")
        rec = rec[~bad]
    return ScanLog.from_records(rec)


def write_scanlog(dst: Union[str, BinaryIO], log: ScanLog, append: bool = False) -> None:
    """Write a ScanLog in the reference's exact on-disk format."""
    rec = log.to_records()
    payload = rec.tobytes()

    def _emit(f: BinaryIO, at_start: bool) -> None:
        if at_start:
            f.write(SCANLOG_FILE_HEADER)
        f.write(payload)

    if isinstance(dst, str):
        mode = "ab" if append else "wb"
        with open(dst, mode) as f:
            _emit(f, f.tell() == 0)
    else:
        at_start = True
        try:
            at_start = dst.tell() == 0
        except (OSError, io.UnsupportedOperation):
            pass
        _emit(dst, at_start)
