"""The JAX package beside the port on the soak's own frames, on the CPU:
the witness that chip_smoke.py's soak phase rests its detection gates on.

    JAX_PLATFORMS=cpu python tests/jax_soak_witness.py [--camera C]
        [--frames N] [--out FILE]
    JAX_PLATFORMS=cpu python tests/jax_soak_witness.py --prior DISPATCHED.json
        [--camera C] [--out FILE]

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

With ``--prior`` it replays the frame-sets the smoke's soak recorded in
``dispatched.json`` (the frames whose outcome on the card differed from
``JAX_SOAK_FOUND``): each through both packages from the tracked prior,
colour tables and params the card's fleet dispatched for it, and prints
whether the JAX package's outcome is the card's and the port's the JAX
package's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

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


def jax_config(config):
    """The JAX package's VisionConfig with the port config's detection keys."""
    from vision_processor_tpu.utils.config import VisionConfig as JConfig

    jconfig = JConfig()
    for key in ("cam_id", "max_blobs", "resampling_factor", "device_finish",
                "resample_mode", "stream_active", "min_circularity"):
        setattr(jconfig, key, getattr(config, key))
    return jconfig


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


def replay(path: Path, camera: int | None) -> list:
    """Both packages on the CPU over the frame-sets of ``path`` (the
    soak's ``dispatched.json``: the inputs the card's fleet dispatched for
    each frame whose outcome differed from ``JAX_SOAK_FOUND``), from the
    recorded tracked prior, colour tables and params, one camera at a time.
    Returns one row a record: the card's outcome and each package's."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as S
    import vision_processor_tpu.app.multicam_app as JMA
    from vision_processor_tpu.app.processor import TrackedArrays as JTracked
    from vision_processor_tpu.io.camera import RawFrame as JRawFrame
    from vision_processor_tpu.proto import SSL_WrapperPacket as JWrapper
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.synthetic import render_raw

    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    records = [r for r in json.loads(path.read_text())
               if camera is None or r["camera"] == camera]
    rig = build_rig(S.N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((S.N_CAMS, 1080, 1920), np.uint8),
                    device=cpu)
    geometry, cams = rig[7], rig[8]
    scenes = S.soak_scenes(cams, rig[9])
    size = tuple(int(v) for v in cams[0][0].size)
    packet = JWrapper()
    packet.ParseFromString(S.fleet_packet(geometry, range(S.N_CAMS)))
    fleets, rows = {}, []
    for rec in records:
        c, k = rec["camera"], rec["entry"]
        if c not in fleets:
            port = S.replay_fleet(torch, geometry, size, c)
            fleets[c] = (port, jax_fleet(jax_config(port.configs[0]), packet.geometry, *size))
        port, jax_app = fleets[c]
        raw = render_raw(cams[c][0], geometry.field, scenes[c][k], "RGGB")
        got = S.replay_dispatched(torch, port, raw, scenes[c][k], rec)
        inputs = S.record_inputs(rec)
        refs = np.stack([p.colors.packed_refs() for p in jax_app.processors])
        if not np.array_equal(refs, inputs["refs"]):
            raise SystemExit(f"camera {c} frame {rec['frame']}: the JAX package's reference "
                             f"colours differ from the dispatched ones")
        jax_app._colors_dev = jnp.asarray(inputs["colors"])
        jax_app._fleet_params = lambda inputs=inputs: inputs["params"]
        saved = JMA.TrackedArrays
        JMA.TrackedArrays = SimpleNamespace(
            build=lambda *_, inputs=inputs: JTracked(**inputs["tracked"]))
        try:
            jout = jax_app.dispatch_frames(
                [JRawFrame(data=raw, fmt="RGGB", width=size[0], height=size[1])],
                rec["now"])
        finally:
            JMA.TrackedArrays = saved
        want = S.judged(scenes[c][k], *S.fin_detections(
            {key: np.asarray(v) for key, v in jout[2].items()}))
        tracked = inputs["tracked"]
        valid = np.flatnonzero(tracked["valid"])
        row = {"mode": rec["mode"], "camera": c, "frame": rec["frame"], "entry": k,
               "card": rec["card"], "jax_previous_frame_prior": rec["jax"],
               "jax": want, "port": got,
               "prior": {"ids": tracked["id"][valid].tolist(),
                         "time_delta": tracked["time_delta"][valid].tolist()}}
        row["jax_as_card"] = (want["all_ids"], want["ball"]) == (rec["card"]["ids"],
                                                                rec["card"]["ball"])
        row["port_as_jax"] = all(got[key] == want[key] for key in ("ids", "ball", "sent"))
        rows.append(row)
        print(f"{rec['mode']} camera {c} frame {rec['frame']} (entry {k}): card ids "
              f"{rec['card']['ids']} ball {rec['card']['ball']}; from the dispatched prior "
              f"(ids {row['prior']['ids']}, time_delta "
              f"{sorted(set(round(t, 4) for t in row['prior']['time_delta']))}): jax ids "
              f"{want['ids']} sent {want['sent']} ball {want['ball']}, port ids {got['ids']} "
              f"sent {got['sent']} ball {got['ball']}; the JAX package "
              f"{'as the card' if row['jax_as_card'] else 'NOT as the card'}, the port "
              f"{'as the JAX package' if row['port_as_jax'] else 'NOT as the JAX package'}",
              flush=True)
    return rows


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--camera", type=int, help="the camera (default 0; with --prior, all)")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--out", type=Path)
    p.add_argument("--prior", type=Path,
                   help="the soak's dispatched.json: replay its frame-sets from the card's "
                        "recorded prior, colour tables and params (with --camera, only "
                        "that camera's)")
    args = p.parse_args()
    if args.prior:
        rows = replay(args.prior, args.camera)
        if args.out:
            args.out.write_text(json.dumps(rows))
        print(json.dumps({"records": len(rows),
                          "jax_as_card": sum(r["jax_as_card"] for r in rows),
                          "port_as_jax": sum(r["port_as_jax"] for r in rows)}))
        return

    import numpy as np
    import torch

    import chip_smoke as S
    from vision_processor_tpu.io.camera import RawFrame as JRawFrame
    from vision_processor_tpu.proto import SSL_WrapperPacket as JWrapper
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.io.synthetic import render_raw

    torch.set_num_threads(4)
    cpu, c = torch.device("cpu"), args.camera or 0
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
    packet = JWrapper()
    packet.ParseFromString(S.fleet_packet(geometry, range(S.N_CAMS)))
    jax_app = jax_fleet(jax_config(config), packet.geometry, width, height)

    slots = port.processors[0].det_cfg.max_tracked
    rows, last = [], {"port": {}, "jax": {}}
    for i in range(args.frames):
        k, now = i % S.SOAK_BANK, 0.01 * i
        before = {name: S.fleet_prior({0: bots}, now) for name, bots in last.items()}
        out = port.dispatch_frames(
            [RawFrame(data=raws[k], fmt="RGGB", width=width, height=height)], now,
            TrackedArrays.build(before["port"], now, slots))
        jax_app.tracked = before["jax"]
        jout = jax_app.dispatch_frames(
            [JRawFrame(data=raws[k], fmt="RGGB", width=width, height=height)], now)
        fin = {key: v.cpu().numpy() for key, v in out[2].items()}
        jfin = {key: np.asarray(v) for key, v in jout[2].items()}
        got = {"port": S.fin_detections(fin), "jax": S.fin_detections(jfin)}
        last = {name: bots for name, (bots, _) in got.items()}
        a, b = fin["colors7"].astype(np.float64), jfin["colors7"].astype(np.float64)
        row = {"frame": i, "entry": k, "dense": k in S.SOAK_DENSE,
               **{name: S.judged(scenes[k], *d) for name, d in got.items()},
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
