"""The JAX package beside the port on the soak's own frames, on the CPU:
the witness that chip_smoke.py's soak phase rests its detection gates on.

    JAX_PLATFORMS=cpu python tests/jax_soak_witness.py [--camera C]
        [--frames N] [--out FILE]

Builds the soak's bank for camera C alone (``chip_smoke.soak_scenes`` over
bench.py's dense rig: 1080p RGGB, max_blobs 2000, factor 1.25, robots and
ball on a 300 mm loop, entries 5 and 11 with the 1900 clutter blobs) and
runs its entries 0, 1, 2, ... (wrapping, N frames) in the warp resample
through a one-camera fleet of each package: the port's
``MultiCamApp.offline`` and the JAX package's ``MultiCamApp`` (its own
``_ensure_step``, ``_device_inputs``, ``_fleet_params`` and
``dispatch_frames``, without sockets or cameras). Both carry the colour
chain on the device, as the soak's fleet does, and take their tracked
prior from their own previous frame. Prints one line a frame: the bank
entry, each package's robot ids within 30 mm of their planted robots,
the ball within 40 mm, and the largest relative difference of the two
colour tables; then one JSON line with the same by frame and, for each
package, ``found_by_loop``. One camera at 1080p: about a minute for 8
frames and under 1 GB of host memory.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ROBOT_MM, BALL_MM = 30.0, 40.0  # the soak's bounds (chip_smoke.py gate (e))


def detections(fin, c: int = 0) -> tuple[dict, list]:
    """Camera c's robots by id (blue + 16) -> (x, y, z, orientation), and
    its balls (x, y), from a step's finished outputs."""
    import numpy as np

    fin = {k: np.asarray(v)[c] for k, v in fin.items()}
    bots = {int(fin["bot_id"][i]): (*map(float, fin["bot_world"][i, :3]),
                                    float(fin["bot_orientation"][i]))
            for i in np.flatnonzero(fin["bot_valid"])}
    balls = [tuple(map(float, fin["ball_world"][j, :2]))
             for j in np.flatnonzero(fin["ball_valid"])]
    return bots, balls


def judged(scene, bots: dict, balls: list) -> dict:
    """Which planted robots were found with their id within ROBOT_MM, and
    whether the ball was found within BALL_MM."""
    truth = {b.bot_id + (16 if b.team == "blue" else 0): b for b in scene.bots}
    ok = sorted(i for i, b in truth.items()
                if i in bots and math.hypot(bots[i][0] - b.x, bots[i][1] - b.y) <= ROBOT_MM)
    ball = scene.balls[0]
    return {"ids": ok, "all_ids": len(ok) == len(truth),
            "ball": any(math.hypot(x - ball.x, y - ball.y) <= BALL_MM for x, y in balls),
            "sent": sorted(bots), "balls": len(balls)}


def found_by_loop(rows: list, name: str) -> dict:
    """For each pass over the bank, one character an entry: "1" where
    package ``name`` named every planted robot (found the ball), "0" where
    not; ``chip_smoke.JAX_SOAK_FOUND`` holds the JAX package's."""
    out = {"ids": [], "ball": []}
    for row in rows:
        for key, flag in (("ids", "all_ids"), ("ball", "ball")):
            if row["entry"] == 0:
                out[key].append("")
            out[key][-1] += "1" if row[name][flag] else "0"
    return out


def prior(bots: dict, now: float) -> dict:
    """The tracked prior a fleet's socket would hold after sending
    ``bots`` at ``now`` (``chip_smoke.tracked_from``)."""
    return {0: [SimpleNamespace(id=i, x=x, y=y, z=z, w=w, vx=0.0, vy=0.0, vw=0.0,
                                timestamp=now) for i, (x, y, z, w) in bots.items()]}


def jax_fleet(config, geometry, width: int, height: int):
    """The JAX package's MultiCamApp for one camera, without its sockets,
    cameras or threads: only what ``dispatch_frames`` reads."""
    import jax

    from vision_processor_tpu.app.multicam_app import MultiCamApp
    from vision_processor_tpu.app.processor import Processor

    app = MultiCamApp.__new__(MultiCamApp)
    app.configs, app.n_cams = [config], 1
    app.processors = [Processor(config, None, None)]
    app._jax, app._step, app._geom_key = jax, None, None
    app.staggered, app._colors_dev = False, None
    app.tracked = {}
    app.sockets = [SimpleNamespace(get_tracked_objects=lambda: app.tracked)]
    app.processors[0].geometry_check(width, height, geometry, 1)
    return app


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--out", type=Path)
    args = p.parse_args()

    import numpy as np
    import torch

    import chip_smoke as S
    from vision_processor_tpu.io.camera import RawFrame as JRawFrame
    from vision_processor_tpu.proto import SSL_WrapperPacket as JWrapper
    from vision_processor_tpu.utils.config import VisionConfig as JConfig
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.io.synthetic import render_raw

    torch.set_num_threads(4)
    cpu, c = torch.device("cpu"), args.camera
    rig = build_rig(S.N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((S.N_CAMS, 1080, 1920), np.uint8),
                    device=cpu)
    geometry, cams = rig[7], rig[8]
    scenes = S.soak_scenes(cams, rig[9])[c]
    model = cams[c][0]
    width, height = (int(v) for v in model.size)
    entries = sorted({i % S.SOAK_BANK for i in range(args.frames)})
    raws = {k: render_raw(model, geometry.field, scenes[k], "RGGB") for k in entries}

    config = S.vision_config("warp", 1.25, c)
    port = MultiCamApp.offline([config], device=cpu)
    port.processors[0].geometry_check(width, height, geometry, 1)
    jconfig = JConfig()
    for key in ("cam_id", "max_blobs", "resampling_factor", "device_finish",
                "resample_mode", "stream_active", "min_circularity"):
        setattr(jconfig, key, getattr(config, key))
    packet = JWrapper()
    packet.ParseFromString(S.fleet_packet(geometry, range(S.N_CAMS)))
    jax_app = jax_fleet(jconfig, packet.geometry, width, height)

    slots = port.processors[0].det_cfg.max_tracked
    rows, last = [], {"port": {}, "jax": {}}
    for i in range(args.frames):
        k, now = i % S.SOAK_BANK, 0.01 * i
        before = {name: prior(bots, now - 0.01) for name, bots in last.items()}
        out = port.dispatch_frames(
            [RawFrame(data=raws[k], fmt="RGGB", width=width, height=height)], now,
            TrackedArrays.build(before["port"], now, slots))
        jax_app.tracked = before["jax"]
        jout = jax_app.dispatch_frames(
            [JRawFrame(data=raws[k], fmt="RGGB", width=width, height=height)], now)
        fin = {key: v.cpu().numpy() for key, v in out[2].items()}
        jfin = {key: np.asarray(v) for key, v in jout[2].items()}
        got = {"port": detections(fin), "jax": detections(jfin)}
        last = {name: bots for name, (bots, _) in got.items()}
        a, b = fin["colors7"].astype(np.float64), jfin["colors7"].astype(np.float64)
        row = {"frame": i, "entry": k, "dense": k in S.SOAK_DENSE,
               **{name: judged(scenes[k], *d) for name, d in got.items()},
               "colour_rel": float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))}
        row["same"] = all(row["port"][key] == row["jax"][key]
                          for key in ("ids", "ball", "sent", "balls"))
        rows.append(row)
        print(f"frame {i} entry {k}{' dense' if row['dense'] else ''}: port ids "
              f"{row['port']['ids']} ball {row['port']['ball']} sent {row['port']['sent']}; "
              f"jax ids {row['jax']['ids']} ball {row['jax']['ball']} sent "
              f"{row['jax']['sent']}; colour tables rel {row['colour_rel']:.2e}; "
              f"{'same' if row['same'] else 'DIFFERENT'}", flush=True)
    summary = {"camera": c,
               "found": {name: found_by_loop(rows, name) for name in ("jax", "port")},
               "frames": rows}
    if args.out:
        args.out.write_text(json.dumps(summary))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
