"""The JAX package beside the port on the degraded-optics frames, on the CPU:
the witness that chip_smoke.py's degraded-optics phase rests its gates on.

    JAX_PLATFORMS=cpu python tests/jax_perturb_witness.py --row R [--out FILE]
    python tests/jax_perturb_witness.py --merge FILE [FILE ...]

Builds the smoke's perturbed frames for row R of
``chip_smoke.PERTURB_ROWS`` (``chip_smoke.perturb_bank``: the 4-camera
bench rig at 1080p RGGB, the soak loop's plain entries, perturbed by
python/perturb.py's optical steps) and runs each camera's six frames in
the warp resample through a one-camera fleet of each package (max_blobs
2000, on-device finishing, the row's circularity and resampling factor):
the port's ``MultiCamApp.offline`` and the JAX package's ``MultiCamApp``
(``jax_soak_witness.jax_fleet``), each taking its tracked prior from its
own previous frame. Prints one line a frame (each package's ids within 30
mm, the ball within 40 mm) and one JSON line: the SHA-256 of each
camera's raws, and for each package the outcome strings, recall, ball
recall and mean robot error. A row takes about 5 minutes and 2 GB; run
the six rows as parallel processes. ``--merge`` prints
``chip_smoke.JAX_PERTURB_FOUND`` from the rows' JSON files.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def run_row(r: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as S
    from jax_soak_witness import jax_config, jax_fleet
    from vision_processor_tpu.io.camera import RawFrame as JRawFrame
    from vision_processor_tpu.proto import SSL_WrapperPacket as JWrapper
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.camera import RawFrame

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    profile, circ, *_, factor = S.PERTURB_ROWS[r]
    rig = build_rig(S.N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((S.N_CAMS, 1080, 1920), np.uint8),
                    device=cpu)
    geometry, cams = rig[7], rig[8]
    bank = S.perturb_bank(cams, geometry, rig[9], profiles=[profile])
    width, height = (int(v) for v in cams[0][0].size)
    packet = JWrapper()
    packet.ParseFromString(S.fleet_packet(geometry, range(S.N_CAMS)))
    scores = {"port": [], "jax": []}
    for c in range(S.N_CAMS):
        config = S.vision_config("warp", factor, c)
        config.min_circularity = circ
        port = MultiCamApp.offline([config], device=cpu)
        port.processors[0].geometry_check(width, height, geometry, 1)
        jax_app = jax_fleet(jax_config(config), packet.geometry, width, height)
        slots = port.processors[0].det_cfg.max_tracked
        last = {"port": {}, "jax": {}}
        for name in scores:
            scores[name].append([])
        for j, raw in enumerate(bank["raws"][profile][c]):
            now = 0.01 * j
            scene = bank["scenes"][c][j]
            out = port.dispatch_frames(
                [RawFrame(data=raw, fmt="RGGB", width=width, height=height)], now,
                TrackedArrays.build(S.fleet_prior({0: last["port"]}, now), now, slots))
            jax_app.tracked = S.fleet_prior({0: last["jax"]}, now)
            jout = jax_app.dispatch_frames(
                [JRawFrame(data=raw, fmt="RGGB", width=width, height=height)], now)
            fins = {"port": {k: v.cpu().numpy() for k, v in out[2].items()},
                    "jax": {k: np.asarray(v) for k, v in jout[2].items()}}
            line = []
            for name, fin in fins.items():
                bots, balls = S.fin_detections(fin)
                last[name] = bots
                score = S.perturb_score(scene, bots, balls)
                scores[name][c].append(score)
                line.append(f"{name} ids {score['ids']} ball {score['ball']} sent "
                            f"{sorted(bots)} errors {[round(e, 2) for e in score['errs']]}")
            print(f"row {r} ({profile}, {factor}) camera {c} frame {j}: " + "; ".join(line),
                  flush=True)
    summary = {name: S.perturb_row_summary(s) for name, s in scores.items()}
    return {"row": r, "profile": profile, "circularity": circ, "factor": factor,
            "digests": bank["digests"][profile], **summary,
            "same": all(summary["port"][k] == summary["jax"][k] for k in ("ids", "ball"))}


def merged(paths: list) -> dict:
    """JAX_PERTURB_FOUND from the rows' JSON files."""
    out = {}
    for path in paths:
        row = json.loads(Path(path).read_text())
        out[row["row"]] = {"ids": row["jax"]["ids"], "ball": row["jax"]["ball"],
                           "err": row["jax"]["mean_err"], "digests": row["digests"]}
    return dict(sorted(out.items()))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--row", type=int)
    p.add_argument("--out", type=Path)
    p.add_argument("--merge", nargs="+")
    args = p.parse_args()
    if args.merge:
        print(json.dumps(merged(args.merge), indent=1))
        return
    summary = run_row(args.row)
    if args.out:
        args.out.write_text(json.dumps(summary))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
