"""The JAX package's counts on bench.py's dense rig, on the CPU: what
chip_smoke.py's bench phase prints beside the port's counts from the card.

    JAX_PLATFORMS=cpu python tests/jax_bench_counts.py [--resample warp|gather]
        [--frames N]

Builds bench.py's dense rig (4 cameras, 1080p RGGB, max_blobs 2000, 1900
extra blobs a camera, factor 1.25), runs ``bench.measure_dense_precision``
(one untracked step and the oracle) and one ``batched_step_host_tracked``
on the bank entry that ends a rollout of N frame-sets (entry (N - 1) % 4 of
bench.py's rolled bank; blob counts do not depend on tracking or colours),
and prints one JSON line: ``blob_counts_dense``,
``dense_bots_device_untracked``, ``dense_bots_oracle`` and the rest of the
precision dict. Several minutes and a few GB of host memory (bench.py's
renderer paints each ball with a full-frame pass).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--resample", choices=("warp", "gather"), default="warp")
    p.add_argument("--frames", type=int, default=5)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked, make_resample_grids,
    )

    rig = bench.build_rig(dense=True, dense_blobs=1900, resampling_factor=1.25,
                          return_scenes=True, resample_mode=args.resample)
    cfg, raws, packed, scales, offsets, colors, params, _, cams, scenes = rig
    marks_one = pack_field_marks(cams[0][1].field, 10.0)
    marks = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *([marks_one] * cfg.n_cams))
    refs = jnp.asarray(np.stack([ColorState().packed_refs()] * cfg.n_cams))
    quality = bench.measure_dense_precision(cfg, raws, packed, scales, offsets, colors,
                                            params, scenes, refs, marks)
    i = (args.frames - 1) % 4
    raw_i = np.roll(raws, (2 * i, 4 * i), axis=(1, 2))
    grids = make_resample_grids(cfg, packed, float(params["max_bot_height"]), scales,
                                offsets)
    tracked = TrackedArrays.build({}, 0.0, cfg.det.max_tracked).as_dict()
    blobs, _ = batched_step_host_tracked(cfg)(jnp.asarray(raw_i), packed, scales, offsets,
                                              colors, tracked, params, grids)
    print(json.dumps({"resample_mode": args.resample, "frames": args.frames,
                      "bank_entry": i,
                      "blob_counts_dense": np.asarray(blobs["count"]).tolist(),
                      **quality}))


if __name__ == "__main__":
    main()
