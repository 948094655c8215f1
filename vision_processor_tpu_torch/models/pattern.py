"""Copy of vision_processor_tpu/models/pattern.py for the port.

SSL robot cover ("butterfly") pattern tables.

The 16 standard SSL id patterns encode robot ids via green/pink side blobs
(1 = green, 0 = pink, msb->lsb in increasing 2D angle from the robot
orientation). Tables mirror the reference (reference src/pattern.h:19-59) but
are derived here from the published blob geometry rather than hard-coded:
blob positions come from the standard 85 mm blob circle, and the
blob-to-blob angles are computed from those positions.
"""
from __future__ import annotations

import math

import numpy as np

# id -> 4-bit green/pink mask, msb = first blob ccw from the robot's nose.
PATTERNS: np.ndarray = np.array(
    [
        0b0100, 0b1100, 0b1101, 0b0101,
        0b0010, 0b1010, 0b1011, 0b0011,
        0b1111, 0b0000, 0b0110, 0b1001,
        0b1110, 0b1000, 0b0111, 0b0001,
    ],
    dtype=np.int32,
)

# 4-bit mask -> robot id (inverse of PATTERNS).
PATTERN_LUT: np.ndarray = np.zeros(16, dtype=np.int32)
for _id, _mask in enumerate(PATTERNS):
    PATTERN_LUT[_mask] = _id

# Blob positions on the cover in robot frame [mm]:
# slot 0 = center blob, slots 1-4 = side blobs in the standard layout.
PATTERN_POS: np.ndarray = np.array(
    [
        [0.0, 0.0],
        [35.0, 54.772],
        [-54.772, 35.0],
        [-54.772, -35.0],
        [35.0, -54.772],
    ],
    dtype=np.float32,
)

# Expected direction angle from blob a towards blob b in the robot frame
# (flattened 5x5): PATTERN_ANGLES_B2B[b*5 + a] = atan2(pos[b] - pos[a]),
# diagonal 0. Indexing matches the reference table (reference src/pattern.h:39-45).
def _angles_b2b() -> np.ndarray:
    out = np.zeros((5, 5), dtype=np.float64)
    for b in range(5):
        for a in range(5):
            if a == b:
                continue
            d = PATTERN_POS[b] - PATTERN_POS[a]
            out[b, a] = math.atan2(d[1], d[0])
    return out.reshape(-1).astype(np.float32)


PATTERN_ANGLES_B2B: np.ndarray = _angles_b2b()

CENTER_BLOB_RADIUS = 25.0  # [mm]
SIDE_BLOB_RADIUS = 20.0  # [mm]
MIN_ROBOT_RADIUS = 85.0  # [mm]
MIN_ROBOT_FRONT_DISTANCE = 55.0  # [mm] flat-front cut distance
MIN_ROBOT_OPENING_ANGLE = 0.86708  # [rad] half opening angle of the flat front
