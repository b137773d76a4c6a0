"""Beam extraction & ToF filtering — vectorized re-expression of the
reference's per-column scan loops.

The reference walks 8 rows per column keeping a running (best, second)
pair (robust_col_dist_m, uav_local_nav.c:1320-1342).  On device the same
second-smallest-valid semantics is one masked sort along the row axis:
invalid cells (0 / 0xFFFF / <=0.02 m after the mm->m conversion) map to
+inf, columns sort ascending, and the beam is element [1] when >=2 valid
returns exist, element [0] when exactly one, NaN when none.  Identical
result for every input, including duplicate minima (the C pair-tracking
also yields the second *element* of the sorted order, not the second
*distinct* value).

All arithmetic is float32, matching the C `float` ops bit-for-bit
(mm * 0.001f, the > 0.02f validity gate, clamp to 4.0f before comparison).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from micro_quad_slam_tpu.utils.config import TofConfig

_F32 = np.float32


def extract_beams(grid_mm: jnp.ndarray, tof: TofConfig = TofConfig()):
    """grid_mm u16 [..., 4, 8, 8] -> (beams f32 [..., 4, 8], minima f32 [..., 4]).

    Rows are axis -2, columns axis -1 (sensor layout: row-major 8x8,
    tof_esp32.ino:200-209).
    """
    mm = grid_mm.astype(jnp.int32)
    m = mm.astype(jnp.float32) * _F32(0.001)
    valid = (mm != 0) & (mm != 0xFFFF) & (m > _F32(tof.min_valid_m))
    m = jnp.minimum(m, _F32(tof.max_range_m))
    m = jnp.where(valid, m, jnp.inf)
    # second-smallest along rows via two min passes (cheaper than a sort:
    # the rows axis has only 8 lanes).  Mask exactly ONE instance of the
    # minimum so duplicate minima still yield second == first, matching
    # the C pair-tracking.
    first = jnp.min(m, axis=-2)
    is_min = m == first[..., None, :]
    first_min_row = jnp.argmax(is_min, axis=-2)
    row_ids = jnp.arange(m.shape[-2])
    shape = (1,) * (m.ndim - 2) + (m.shape[-2], 1)
    mask_one = first_min_row[..., None, :] == row_ids.reshape(shape)
    second = jnp.min(jnp.where(mask_one, jnp.inf, m), axis=-2)
    count = valid.sum(axis=-2)
    beams = jnp.where(
        count >= 2, second, jnp.where(count == 1, first, jnp.nan)
    )
    minima = jnp.min(jnp.where(jnp.isnan(beams), jnp.inf, beams), axis=-1)
    minima = jnp.where(jnp.isinf(minima), jnp.nan, minima)
    return beams, minima


def tof_filter_update(
    filt: jnp.ndarray, minima: jnp.ndarray, alpha: float = 0.20
) -> jnp.ndarray:
    """NaN-aware EMA on per-direction minima (uav_local_nav.c:1430-1438):
    skip NaN samples, adopt the first sample directly, then
    (1-a)*filt + a*v in float32."""
    a = _F32(alpha)
    # The selects pin the arithmetic to mul-then-add in EVERY compilation
    # context: a bare (1-a)*filt + a*minima gets fma-contracted by LLVM in
    # some fusion shapes but not others (optimization_barrier does not
    # survive into codegen), and the 1-ULP skew breaks cross-kernel
    # bit-equality of filt.  where(x == x, p, y) is value-identity on
    # non-NaN lanes (NaN lanes are overridden below) yet blocks the
    # fadd(fmul) contraction pattern (bit-equality of filt with the CPU
    # on the GPU is checked by chip_smoke.py).
    p1 = jnp.where(filt == filt, (_F32(1.0) - a) * filt, minima)
    p2 = jnp.where(minima == minima, a * minima, filt)
    blended = p1 + p2
    upd = jnp.where(jnp.isnan(filt), minima, blended)
    return jnp.where(jnp.isnan(minima), filt, upd)
