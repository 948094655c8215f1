"""Background snapshot writer: latest-image-per-path JPEG dumps.

Copy of vision_processor_tpu/io/snapshot.py for the port. Mirrors the
reference SnapshotWriter (reference src/snapshotwriter.cpp:27-103): a
background thread keeps only the newest image offered per path, encodes
JPEG q85 and writes atomically (tmp + rename) so the wrapper UI never reads
half-written files.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np

from ..utils.log import get_logger

log = get_logger(__name__)


class SnapshotWriter:
    def __init__(self):
        self._pending: dict[str, np.ndarray] = {}
        self._cond = threading.Condition()
        self._closing = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def offer(self, image: np.ndarray, path: str) -> None:
        """Queue an (H, W, 3) RGB or (H, W) grayscale image for `path`."""
        with self._cond:
            self._pending[str(path)] = np.asarray(image)
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        import cv2

        while True:
            with self._cond:
                while not self._pending and not self._closing:
                    self._cond.wait(0.5)
                if self._closing and not self._pending:
                    return
                items = list(self._pending.items())
                self._pending.clear()
            for path, img in items:
                try:
                    p = Path(path)
                    p.parent.mkdir(parents=True, exist_ok=True)
                    if img.ndim == 3:
                        img = img[..., ::-1]  # RGB -> BGR for imwrite
                    tmp = str(p) + ".tmp.jpg"
                    cv2.imwrite(
                        tmp,
                        np.clip(img, 0, 255).astype(np.uint8),
                        [cv2.IMWRITE_JPEG_QUALITY, 85],
                    )
                    os.replace(tmp, p)
                except Exception as exc:
                    log.warning("snapshot write failed for %s: %s", path, exc)
