"""Copy of vision_processor_tpu/models/colors.py for the port.

Adaptive color calibration state (host-side).

Per-frame color re-estimation from the accepted bot constellations and ball
candidates, blending new estimates with reference priors and history
(reference src/blobs/colorupdate.cpp:58-120). Colors live in the dRGB space
produced by the resampling stage, stored as integer vectors to preserve the
reference's integer blend/division semantics.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from .kmeans import kmeans2
from .pattern import PATTERNS


def _as3i(v) -> np.ndarray:
    return np.asarray(v, dtype=np.int64)


@dataclass
class ColorState:
    orange_ref: np.ndarray = dc_field(default_factory=lambda: _as3i([192, 128, 64]))
    field_ref: np.ndarray = dc_field(default_factory=lambda: _as3i([128, 128, 128]))
    yellow_ref: np.ndarray = dc_field(default_factory=lambda: _as3i([255, 128, 0]))
    blue_ref: np.ndarray = dc_field(default_factory=lambda: _as3i([0, 128, 255]))
    green_ref: np.ndarray = dc_field(default_factory=lambda: _as3i([0, 255, 128]))
    pink_ref: np.ndarray = dc_field(default_factory=lambda: _as3i([255, 0, 128]))
    reference_force: float = 0.1
    history_force: float = 0.7

    def __post_init__(self):
        self.orange = self.orange_ref.copy()
        self.field = self.field_ref.copy()
        self.yellow = self.yellow_ref.copy()
        self.blue = self.blue_ref.copy()
        self.green = self.green_ref.copy()
        self.pink = self.pink_ref.copy()
        self.field_line = self.field_ref.copy()

    def packed(self) -> np.ndarray:
        """(7, 3) f32: orange, field, yellow, blue, green, pink, field_line —
        the device-side color table."""
        return np.stack(
            [
                self.orange,
                self.field,
                self.yellow,
                self.blue,
                self.green,
                self.pink,
                self.field_line,
            ]
        ).astype(np.float32)

    def packed_refs(self) -> np.ndarray:
        """(7, 3) f32 reference colors in the packed() row order (the
        field-line row has no reference — it is never blended — so the
        field reference fills the slot)."""
        return np.stack(
            [
                self.orange_ref,
                self.field_ref,
                self.yellow_ref,
                self.blue_ref,
                self.green_ref,
                self.pink_ref,
                self.field_ref,
            ]
        ).astype(np.float32)

    def adopt_packed(self, colors7: np.ndarray) -> None:
        """Adopt a device-updated (7, 3) color table (the in-graph
        finisher's output) as the live state."""
        c = np.asarray(colors7).astype(np.int64)
        self.orange, self.field, self.yellow, self.blue = c[0], c[1], c[2], c[3]
        self.green, self.pink, self.field_line = c[4], c[5], c[6]

    def _blend(self, reference: np.ndarray, old: np.ndarray, new: np.ndarray):
        update_force = 1.0 - self.reference_force - self.history_force
        mixed = (
            self.reference_force * reference.astype(np.float64)
            + self.history_force * old.astype(np.float64)
            + update_force * new.astype(np.float64)
        )
        # truncation like the reference cast, with a boundary nudge: a
        # stationary color (ref==old==new==v) lands exactly on the integer
        # boundary, where rounding error makes trunc(v - ulp) = v-1 — the
        # color would random-walk downward. The nudge keeps exact-boundary
        # cases stable (device finisher applies the same epsilon).
        return np.trunc(mixed + 1e-3).astype(np.int64)

    def update(self, bots: list, balls: list) -> None:
        """Per-frame update.

        bots: objects with .bot_id and .blob_colors (5, 3) int / None rows
        balls: objects with .blob_color and .blob_center (dRGB int vectors)
        """
        old = {
            "field": self.field.copy(),
            "orange": self.orange.copy(),
            "yellow": self.yellow.copy(),
            "blue": self.blue.copy(),
            "green": self.green.copy(),
            "pink": self.pink.copy(),
        }

        center_blobs = []
        pink_sum = np.zeros(3, dtype=np.int64)
        green_sum = np.zeros(3, dtype=np.int64)
        pink_n = green_n = 0
        for bot in bots:
            colors = bot.blob_colors
            if colors[0] is not None:
                center_blobs.append(_as3i(colors[0]))
            pattern = int(PATTERNS[bot.bot_id % 16])
            for slot in range(1, 5):
                if colors[slot] is None:
                    continue
                if (pattern >> (4 - slot)) & 1:
                    green_sum += _as3i(colors[slot])
                    green_n += 1
                else:
                    pink_sum += _as3i(colors[slot])
                    pink_n += 1

        if pink_n > 0:
            self.pink = self._blend(self.pink_ref, old["pink"], pink_sum // pink_n)
        if green_n > 0:
            self.green = self._blend(
                self.green_ref, old["green"], green_sum // green_n
            )

        ok, y, b = kmeans2(self.pink, center_blobs, self.yellow, self.blue)
        if ok:
            self.yellow = self._blend(self.yellow_ref, old["yellow"], y)
            self.blue = self._blend(self.blue_ref, old["blue"], b)
        else:
            self.yellow, self.blue = y, b

        ball_centers = [_as3i(ball.blob_center) for ball in balls]
        ok, o, f = kmeans2(self.blue, ball_centers, self.orange, self.field)
        if ok:
            self.orange = self._blend(self.orange_ref, old["orange"], o)
            self.field = self._blend(self.field_ref, old["field"], f)
        else:
            self.orange, self.field = o, f

    def update_field_line(self, line_ball_colors: list[np.ndarray]) -> None:
        """Field-line blob color = mean color of ball candidates lying on the
        field markings (reference src/blobs/colorupdate.cpp:42-56)."""
        if len(line_ball_colors) > 2:
            total = np.sum(np.asarray(line_ball_colors, dtype=np.int64), axis=0)
            self.field_line = total // len(line_ball_colors)
