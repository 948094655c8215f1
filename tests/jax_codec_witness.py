"""The JAX package's App on the codec round trip's frames, on the CPU: the
witness that chip_smoke.py's codec phase holds the card to.

    JAX_PLATFORMS=cpu python tests/jax_codec_witness.py [--out FILE]

Builds the phase's frames (``chip_smoke.codec_bank``: rig camera 0 of the
bench rig, 1080p RGGB, over the soak loop's plain entries, through the
port's H.264 encoder at qp 24 and cv2's decoder) and runs them through the
App of each package on the CPU (``chip_smoke.codec_app_run``) under
``chip_smoke.codec_config`` with the debug stream off (it sends nothing
the detections depend on) and the warp resample (what "auto" resolves to
on the card; on the CPU it takes the gather): the JAX package's ``App``
and the port's ``App(device="cpu")``. Prints one line a frame and, last,
the JSON that ``chip_smoke.JAX_CODEC_FOUND`` holds: the decoded frames'
SHA-256 and the JAX App's detection frames (``codec_frame``). Rerun it and paste its last
line into JAX_CODEC_FOUND when the rig, the soak loop, the encoder, cv2's
decoder or the shipped config.yml changes. About two minutes and 2 GB.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def witness(work: Path) -> dict:
    import numpy as np
    import torch

    import chip_smoke as S
    from vision_processor_tpu_torch.bench import build_rig

    torch.set_num_threads(4)
    rig = build_rig(S.N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((S.N_CAMS, 1080, 1920), np.uint8),
                    device="cpu")
    geometry, cams = rig[7], rig[8]
    bank = S.codec_bank(cams, geometry, rig[9], work / "codec.h264")
    size = tuple(int(v) for v in cams[0][0].size)
    packet = S.geometry_packet(geometry, 0)
    got = {}
    for name, pkg, kw in (("jax", "vision_processor_tpu", {}),
                          ("port", "vision_processor_tpu_torch", {"device": "cpu"})):
        cfg = S.codec_config(work / name, stream=False, mode="warp")
        got[name], _, _ = S.codec_app_run(pkg, cfg, bank["raws"], size, packet, **kw)
    want = {"digest": bank["digest"], "frames": got["jax"]}
    port, bad = S.codec_verdict(got["port"], bank["scenes"], want)
    jax_self, jax_bad = S.codec_verdict(got["jax"], bank["scenes"], want)
    for k, f in enumerate(got["jax"]):
        print(f"frame {k + 1}: JAX robots {f['bots']} balls {f['balls']}; worst robot "
              f"{jax_self['max_bot_err_mm'][k]:.3f} mm, ball "
              f"{jax_self['ball_err_mm'][k]:.3f} mm", flush=True)
    print(f"the JAX App against the bars: {jax_bad or 'clears them'}")
    print(f"the port's App on the CPU: largest distance from the JAX App's "
          f"{port['max_diff_from_jax_mm']:.6f} mm; {bad or 'the same ids in every frame'}")
    return want


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=Path)
    args = p.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        want = witness(Path(tmp))
    if args.out:
        args.out.write_text(json.dumps(want))
    print(json.dumps(want))


if __name__ == "__main__":
    main()
