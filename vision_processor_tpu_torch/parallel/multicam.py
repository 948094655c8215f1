"""Multi-camera scale-out: N cameras on one card, and a camera mesh of
cards over ``torch.distributed`` (PyTorch port of parallel/multicam.py).

Counterpart of vision_processor_tpu/parallel/multicam.py. The reference
runs one process per camera, coordinated by UDP multicast (reference
README architecture, src/udpsocket.cpp:204-301); the JAX package runs the
cameras of one chip as one program with the camera axis unrolled. Here the
``*_step`` builders return plain functions over tensors with a leading
camera axis: the blob machine and hypothesis search run camera by camera
(``_single_cam_step``, the same kernels as the one-camera path), then one
pass over the stacked cameras completes them (``finalize_batched``: the
clipping NMS, the ball clip, the id estimate folded over the camera axis)
and, with field markings, the on-device finisher (on a card one CUDA
graph replay, ``models/device_finish.py FinisherGraph``, one for each
step).

``resample_grids`` is the JAX package's ``resample_grids_traced``
(nothing is traced here). Every step takes the cached sampling grids
(``rs_grids``, from ``make_resample_grids``) or, with ``rs_grids=None``,
resamples each camera in line: the camera projection per flat pixel, then
the packed sampler (kernel E2/E3), as the JAX package does without grids.

The mesh part is the JAX package's ``shard_map`` over a camera mesh as one
process per rank (``torchrun``, or any launcher that sets the rank and the
world size): ``make_camera_group`` joins the process group (NCCL on the
rank's card; gloo only for CPU tensors), and ``sharded_step`` /
``sharded_rollout`` run the rank's ``n_cams // world`` cameras in line
(``rs_grids=None``, or the rollout's own grids) and all-gather the
detection summaries after every frame-set, the collective that replaces
the multicast bus. Every rank holds only its own cameras' inputs; the
params are replicated, and per-camera tunables are sliced by global camera
id. The exchange never goes through the host.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models.detector import (
    TWO_PI, DetectorConfig, detect, estimate_bot_ids, finalize_detections_batched,
)
from ..models.device_finish import (
    FinisherGraph, finish_on_device_batched, stack_finish_params,
)
from ..ops.pipeline import BlobMachineConfig, blob_machine
from ..utils.timing import RECORDER

_INF = float("inf")

# Tunables that may differ between the cameras of one fleet: the reference
# gives every camera its own config (reference src/Resources.cpp:188-214).
# A params dict carries these as scalars (shared) or as (n_cams,) tensors
# (per camera); params_for_cam slices the per-camera form.
_PER_CAMERA_PARAM_KEYS = frozenset({
    "min_circularity",
    "min_tracking_radius",
    "max_bot_acceleration",
    "min_confidence",
    "clipping_tolerance",
    "color_plausibility_veto",
    # on-device finishing tunables (models/device_finish.py)
    "min_score",
    "min_cam_edge_distance",
    "reference_force",
    "history_force",
})


def params_for_cam(params: dict, c: int) -> dict:
    """Camera ``c``'s view of a fleet params dict (scalars pass through;
    per-camera (n_cams,) tensors are indexed)."""
    return {
        k: v[c] if k in _PER_CAMERA_PARAM_KEYS and getattr(v, "ndim", 0) >= 1 else v
        for k, v in params.items()
    }


def _shard_param(v, cam0: int, n_local: int):
    """This rank's (n_local,) window of a possibly per-camera tunable: the
    replicated params carry global (n_cams,) tensors, and the rank's
    cameras start at global id ``cam0``. Scalars pass through."""
    if getattr(v, "ndim", 0) >= 1:
        return v[cam0:cam0 + n_local]
    return v


def _cam(tree: dict, c: int) -> dict:
    return {k: v[c] for k, v in tree.items()}


def _stack(trees: list) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@dataclass(frozen=True)
class MultiCamConfig:
    bm: BlobMachineConfig
    det: DetectorConfig
    n_cams: int


def _single_cam_step(cfg: MultiCamConfig, raw, packed_cam, field_scale, field_offset,
                     colors7, tracked, params, rs_grid=None, finalize: bool = True,
                     camera: int | None = None):
    """One camera's frame -> blob slots (+ detection summary).

    ``finalize=False`` returns ``(blobs, det)`` with the detections before
    the clipping NMS and without the id estimate or summary: callers
    stacking several cameras complete them with ``finalize_batched``.
    Without ``rs_grid`` the frame is resampled in line. ``camera``: the
    camera of the recorder's spans."""
    with RECORDER.span("step.blobs", camera=camera):
        blobs = blob_machine(cfg.bm, raw, packed_cam, params["max_bot_height"],
                             params["min_circularity"], field_scale=field_scale,
                             field_offset=field_offset, rs_grid=rs_grid)
    with RECORDER.span("step.detect", camera=camera):
        det = detect(cfg.det, blobs, tracked, colors7[:6], packed_cam, params,
                     with_nms=finalize)
    out_blobs = {k: blobs[k]
                 for k in ("field_pos", "color", "center", "circ", "score", "valid", "count")}
    if not finalize:
        return out_blobs, det
    bot_id = estimate_bot_ids(det, blobs["color"], colors7)
    det["bot_id_est"] = bot_id
    return out_blobs, det, _summary(det, bot_id)


def _summary(det: dict, bot_id: torch.Tensor) -> dict:
    return {
        "pos": det["bot_pos"],
        "orientation": det["bot_orientation"],
        "score": torch.where(det["bot_valid"], det["bot_score"], 0.0),
        "id": torch.where(det["bot_valid"], bot_id, -1),
    }


def finalize_batched(blobs, det, colors7, clipping_tolerance, ball_radius):
    """Complete ``_single_cam_step(finalize=False)`` outputs over the
    stacked camera axis: clipping NMS and ball-clip mask, the id estimate
    folded over the camera axis, and the detection summary. Returns (det,
    summary), equal to the per-camera path's."""
    with RECORDER.span("step.finalize"):
        det = finalize_detections_batched(det, blobs["field_pos"], blobs["valid"],
                                          clipping_tolerance, ball_radius)
        bot_id = estimate_bot_ids(det, blobs["color"], colors7)
        det["bot_id_est"] = bot_id
        return det, _summary(det, bot_id)


def tracked_from_summaries(det_cfg: DetectorConfig, summaries, time_delta,
                           prev_summaries=None, bot_heights=None):
    """Tracked-bot tensors from (all cameras') detection summaries.

    summaries: dict of stacked (n_cams, B, ...) tensors from the previous
    frame. Entries are deduplicated by bot id first, keeping the best-score
    observation per id (ties: lowest slot), then the top ``max_tracked`` by
    score (ties: lowest slot, as ``jax.lax.top_k``). With ``prev_summaries``
    (the frame before) each selected id gets finite-difference linear and
    angular velocities from its first previous observation; without, zero.
    ``bot_heights``: optional (2,) [yellow, blue] tracking heights in mm,
    default 143 (reference src/udpsocket.cpp:204-256, 304-314)."""
    t = det_cfg.max_tracked
    pos = summaries["pos"].reshape(-1, 2)
    orient = summaries["orientation"].reshape(-1)
    score = summaries["score"].reshape(-1)
    ids = summaries["id"].reshape(-1)
    n = score.shape[0]
    dev = score.device
    valid = (score > 0.0) & (ids >= 0)

    # dedup by id: the single best-score entry per id, ties to the lowest slot
    iid = torch.where(valid, ids.clamp(0, 31), 32).long()
    sc = torch.where(valid, score, -_INF)
    best = torch.full((33,), -_INF, dtype=score.dtype, device=dev).scatter_reduce(
        0, iid, sc, "amax", include_self=True)
    is_max = valid & (sc == best[iid])
    slot_i = torch.arange(n, dtype=torch.int32, device=dev)
    slot = torch.where(is_max, slot_i, n)
    first = torch.full((33,), n, dtype=torch.int32, device=dev).scatter_reduce(
        0, iid, slot, "amin", include_self=True)
    valid = valid & is_max & (slot_i == first[iid])

    # a stable descending sort: lax.top_k's tie order, which torch.topk
    # does not promise on the card
    top_score, top_i = torch.sort(torch.where(valid, score, -_INF), descending=True,
                                  stable=True)
    top_score, top_i = top_score[:t], top_i[:t]
    keep = top_score > 0.0
    sel_ids = torch.where(keep, ids[top_i], -1).to(torch.int32)
    sel_x = pos[top_i, 0]
    sel_y = pos[top_i, 1]
    sel_w = orient[top_i]
    td = torch.as_tensor(time_delta, dtype=torch.float32, device=dev)
    vx = vy = vw = torch.zeros(t, dtype=torch.float32, device=dev)
    if prev_summaries is not None:
        ppos = prev_summaries["pos"].reshape(-1, 2)
        porient = prev_summaries["orientation"].reshape(-1)
        pscore = prev_summaries["score"].reshape(-1)
        pids = prev_summaries["id"].reshape(-1)
        pvalid = (pscore > 0.0) & (pids >= 0)
        # first previous-frame observation of each selected id
        match = ((sel_ids[:, None] == pids[None, :]) & pvalid[None, :]
                 & (sel_ids[:, None] >= 0))
        found = match.any(dim=1)
        j = torch.argmax(match.to(torch.int32), dim=1)  # the first maximum
        dt = torch.clamp_min(td, 1e-4)
        vx = torch.where(found, (sel_x - ppos[j, 0]) / dt, 0.0)
        vy = torch.where(found, (sel_y - ppos[j, 1]) / dt, 0.0)
        dw = sel_w - porient[j]
        dw = dw - TWO_PI * torch.round(dw / TWO_PI)  # shortest angular difference
        vw = torch.where(found, dw / dt, 0.0)
    if bot_heights is None:
        z = torch.full((t,), 143.0, dtype=torch.float32, device=dev)
    else:
        heights = torch.as_tensor(bot_heights, dtype=torch.float32, device=dev)
        z = torch.where(sel_ids >= 16, heights[1], heights[0])
    return {
        "id": sel_ids, "x": sel_x, "y": sel_y, "z": z, "w": sel_w,
        "vx": vx, "vy": vy, "vw": vw,
        "time_delta": td.expand(t).clone(),
        "valid": keep,
    }


# ---------------------------------------------------------------------------
# one card: the camera batch
# ---------------------------------------------------------------------------


def resample_grids(cfg: MultiCamConfig, packed_cams, max_bot_height, field_scales,
                   field_offsets) -> dict:
    """Stacked per-camera sampling geometry (leading camera axis), from
    tensors on the card; each camera's grid uses its own scale and offset."""
    return _stack([
        cfg.bm.make_resample_grid(packed_cams[c], max_bot_height,
                                  field_scale=field_scales[c],
                                  field_offset=field_offsets[c])
        for c in range(cfg.n_cams)
    ])


def make_resample_grids(cfg: MultiCamConfig, packed_cams, max_bot_height, field_scales,
                        field_offsets, device="cuda") -> dict:
    """Host-side cache entry point: numpy (n_cams, ...) camera inputs ->
    the stacked frame-invariant grids on ``device``. Recompute on
    calibration or bot-height change only."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)  # noqa: E731
    return resample_grids(cfg, f32(packed_cams), float(max_bot_height),
                          f32(field_scales), f32(field_offsets))


def _cores(cfg, raws, packed_cams, field_scales, field_offsets, colors7, tracked,
           params, rs_grids, cam0: int = 0):
    """The per-camera cores, stacked: (blobs, det) with a camera axis. The
    inputs hold cameras ``cam0``, ``cam0 + 1``, ... (a rank's share of a
    camera mesh); per-camera tunables are indexed by global camera id."""
    outs = [
        _single_cam_step(cfg, raws[c], packed_cams[c], field_scales[c], field_offsets[c],
                         colors7[c], tracked, params_for_cam(params, cam0 + c),
                         rs_grid=None if rs_grids is None else _cam(rs_grids, c),
                         finalize=False, camera=cam0 + c)
        for c in range(len(raws))
    ]
    return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])


def _finish(finisher, cfg, blobs, det, colors7, packed_cams, params, colors7_refs,
            marks):
    """The on-device finisher through the step's ``FinisherGraph``."""
    with RECORDER.span("step.finisher"):
        return finisher(blobs, det, colors7, colors7_refs, packed_cams, marks,
                        stack_finish_params(params, cfg.n_cams))


def batched_step(cfg: MultiCamConfig):
    """A function running every camera of the card for one frame-set.

    Inputs carry a leading camera axis; the tracked prior is built from the
    previous frame-set's summaries of all cameras and shared by every
    camera. ``rs_grids`` (from ``make_resample_grids``) replays the cached
    projection geometry; without it each camera is resampled in line.
    Returns (blobs, det, summary), plus ``fin`` with
    ``colors7_refs``/``marks``. The finisher replays as a CUDA graph on a
    card (``step.finisher``, a ``FinisherGraph``)."""
    finisher = FinisherGraph()

    def step(raws, packed_cams, field_scales, field_offsets, colors7, prev_summary,
             params, rs_grids=None, prev_prev_summary=None, colors7_refs=None,
             marks=None):
        tracked = tracked_from_summaries(
            cfg.det, prev_summary, params["tracked_time_delta"],
            prev_summaries=prev_prev_summary, bot_heights=params.get("bot_heights_yb"))
        blobs, det = _cores(cfg, raws, packed_cams, field_scales, field_offsets,
                            colors7, tracked, params, rs_grids)
        det, summary = finalize_batched(blobs, det, colors7, params["clipping_tolerance"],
                                        params["ball_radius"])
        if marks is None:
            return blobs, det, summary
        fin = _finish(finisher, cfg, blobs, det, colors7, packed_cams, params,
                      colors7_refs, marks)
        return blobs, det, summary, fin

    step.finisher = finisher
    return step


def batched_step_host_tracked(cfg: MultiCamConfig):
    """Like ``batched_step``, with the tracked prior supplied by the host
    (the production app builds it from the UDP tracker every frame-set, so
    host-side id assignment stays authoritative). Returns (blobs, det), plus
    ``fin`` with ``colors7_refs``/``marks``; ``step.finisher`` as in
    ``batched_step``."""
    finisher = FinisherGraph()

    def step(raws, packed_cams, field_scales, field_offsets, colors7, tracked, params,
             rs_grids=None, colors7_refs=None, marks=None):
        blobs, det = _cores(cfg, raws, packed_cams, field_scales, field_offsets,
                            colors7, tracked, params, rs_grids)
        det, _ = finalize_batched(blobs, det, colors7, params["clipping_tolerance"],
                                  params["ball_radius"])
        if marks is None:
            return blobs, det
        fin = _finish(finisher, cfg, blobs, det, colors7, packed_cams, params,
                      colors7_refs, marks)
        return blobs, det, fin

    step.finisher = finisher
    return step


def percam_core_step(cfg: MultiCamConfig):
    """One camera's blob machine + hypothesis search (finalize deferred):
    the unit of the staggered plan, in which camera c's core is enqueued as
    soon as its raw frame is on the card. Callers slice per-camera tunables
    with ``params_for_cam`` first."""

    def step(raw, packed_cam, field_scale, field_offset, colors7, tracked, params,
             rs_grid=None, camera=None):
        return _single_cam_step(cfg, raw, packed_cam, field_scale, field_offset,
                                colors7, tracked, params, rs_grid=rs_grid, finalize=False,
                                camera=camera)

    return step


def staggered_tail_step(cfg: MultiCamConfig):
    """The stacked tail of the staggered plan: ``finalize_batched`` and the
    on-device finisher over the stacked per-camera core outputs. With
    ``marks=None`` it is the finalize only and ``fin`` is None;
    ``tail.finisher`` as in ``batched_step``."""
    finisher = FinisherGraph()

    def tail(blobs, det, colors7, packed_cams, params, colors7_refs=None, marks=None):
        det, _ = finalize_batched(blobs, det, colors7, params["clipping_tolerance"],
                                  params["ball_radius"])
        if marks is None:
            return det, None
        return det, _finish(finisher, cfg, blobs, det, colors7, packed_cams, params,
                            colors7_refs, marks)

    tail.finisher = finisher
    return tail


def _empty_summary_local(cfg: MultiCamConfig, n_local: int = 1, device="cuda") -> dict:
    b = cfg.det.max_bots
    return {
        "pos": torch.zeros((n_local, b, 2), dtype=torch.float32, device=device),
        "orientation": torch.zeros((n_local, b), dtype=torch.float32, device=device),
        "score": torch.zeros((n_local, b), dtype=torch.float32, device=device),
        "id": torch.full((n_local, b), -1, dtype=torch.int32, device=device),
    }


def empty_summary(cfg: MultiCamConfig, device="cuda") -> dict:
    return _empty_summary_local(cfg, cfg.n_cams, device)


def make_rollout(cfg: MultiCamConfig, step_fn, n_frames: int):
    """An N-frame-set loop (the JAX package's ``lax.scan`` as a Python
    loop): each frame-set takes the next entry of a bank of frames
    (raw_bank (K, n_cams, ...)) and feeds the previous summaries back as
    tracking priors. Returns fn(raw_bank, packed_cams, field_scales,
    field_offsets, colors7, params[, colors7_refs, marks]) -> (carry,
    compact): carry (frame count, summary, previous summary, colours),
    compact a dict of per-frame-set tensors stacked on a leading axis.

    With ``colors7_refs``/``marks`` the on-device finisher runs every
    frame-set and the colour table is carried from one to the next, as the
    production app carries it."""

    def rollout(raw_bank, packed_cams, field_scales, field_offsets, colors7, params,
                colors7_refs=None, marks=None):
        dev = raw_bank.device
        n_bank = raw_bank.shape[0]
        # frame-invariant sampling geometry, once per rollout
        grids = resample_grids(cfg, packed_cams, params["max_bot_height"], field_scales,
                               field_offsets)
        summary = prev = empty_summary(cfg, dev)
        colors = colors7
        compacts = []
        for i in range(n_frames):
            raws = raw_bank[i % n_bank]
            if marks is None:
                blobs, det, nxt = step_fn(raws, packed_cams, field_scales, field_offsets,
                                          colors, summary, params, grids, prev)
                n_balls = torch.zeros(cfg.n_cams, dtype=torch.int32, device=dev)
            else:
                blobs, det, nxt, fin = step_fn(
                    raws, packed_cams, field_scales, field_offsets, colors, summary,
                    params, grids, prev, colors7_refs, marks)
                colors = fin["colors7"]
                n_balls = fin["ball_valid"].sum(dim=-1).to(torch.int32)
            compacts.append({"count": blobs["count"], "bot_valid": det["bot_valid"],
                             "bot_pos": det["bot_pos"], "n_balls": n_balls})
            summary, prev = nxt, summary
        return (n_frames, summary, prev, colors), _stack(compacts)

    return rollout


# ---------------------------------------------------------------------------
# a mesh of cards: one process per rank over torch.distributed
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CameraGroup:
    """One rank's view of the camera mesh: the process group, this rank,
    the world size and the device the rank's cameras run on."""

    group: object
    rank: int
    world: int
    device: torch.device


def make_camera_group(device=None, backend=None, init_method=None, rank: int = -1,
                      world_size: int = -1) -> CameraGroup:
    """The camera mesh as this process sees it (the JAX package's
    ``make_camera_mesh``).

    ``device`` defaults to ``cuda:LOCAL_RANK``: one card per rank, NCCL
    between them. ``device="cpu"`` takes gloo; no other pairing is accepted,
    so a rank that asked for a card never falls back to the host. The
    default process group is used when one is initialised; otherwise one is
    initialised from ``init_method``, ``rank`` and ``world_size`` as
    ``init_process_group`` takes them (default ``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, as ``torchrun``
    sets them)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    backend = want if backend is None else backend
    if backend != want:
        raise ValueError(f"the camera mesh runs {want} on a {device.type} device, "
                         f"not {backend}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_camera_group: {device} asked for and CUDA is "
                               "not available")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        # a card's communicator is set up here, not at the first gather
        eager = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **eager)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default process group runs {dist.get_backend()}, "
                         f"and a {device.type} device needs {backend}")
    return CameraGroup(group=dist.group.WORLD, rank=dist.get_rank(),
                       world=dist.get_world_size(), device=device)


def _local_cameras(cfg: MultiCamConfig, group: CameraGroup) -> int:
    if cfg.n_cams % group.world:
        raise ValueError(f"n_cams={cfg.n_cams} must divide over {group.world} ranks")
    return cfg.n_cams // group.world


def _all_gather(group: CameraGroup, summary: dict) -> dict:
    """Every rank's summaries, field by field, in the JAX layout (world,
    n_local, max_bots, ...): gathered as the concatenation along the first
    axis (the one output layout gloo takes) and viewed as a stack."""
    out = {}
    for k, x in summary.items():
        x = x.contiguous()
        buf = torch.empty((group.world * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(buf, x, group=group.group)
        out[k] = buf.view(group.world, *x.shape)
    return out


def sharded_step(cfg: MultiCamConfig, group: CameraGroup, fused: bool = False):
    """A function running this rank's ``n_cams / world`` cameras for one
    frame-set, their summaries all-gathered over the group.

    Inputs carry this rank's cameras on a leading local axis (global ids
    ``rank * n_local`` on); ``prev_gathered`` is the previous frame-set's
    gathered summary, (world, n_local, max_bots, ...), the same on every
    rank; ``params`` is replicated. Each camera is resampled in line. With
    ``fused=True`` the call takes ``colors7_refs`` (this rank's cameras) and
    ``marks`` (the field's, broadcast to the local cameras) and runs the
    on-device finisher. Returns (blobs, det, gathered), plus ``fin``."""
    n_local = _local_cameras(cfg, group)
    cam0 = group.rank * n_local

    def step(raws, packed_cams, field_scales, field_offsets, colors7, prev_gathered,
             params, colors7_refs=None, marks=None):
        if fused and marks is None:
            raise ValueError("sharded_step(fused=True) needs colors7_refs and marks")
        tracked = tracked_from_summaries(cfg.det, prev_gathered,
                                         params["tracked_time_delta"],
                                         bot_heights=params.get("bot_heights_yb"))
        blobs, det = _cores(cfg, raws, packed_cams, field_scales, field_offsets, colors7,
                            tracked, params, None, cam0)
        det, summary = finalize_batched(
            blobs, det, colors7, _shard_param(params["clipping_tolerance"], cam0, n_local),
            params["ball_radius"])
        gathered = _all_gather(group, summary)
        if not fused:
            return blobs, det, gathered
        fparams = {k: _shard_param(v, cam0, n_local) if k in _PER_CAMERA_PARAM_KEYS else v
                   for k, v in params.items()}
        marks_l = {k: torch.broadcast_to(v, (n_local, *v.shape)) for k, v in marks.items()}
        fin = finish_on_device_batched(blobs, det, colors7, colors7_refs, packed_cams,
                                       marks_l, stack_finish_params(fparams, n_local))
        return blobs, det, gathered, fin

    return step


def sharded_rollout(cfg: MultiCamConfig, group: CameraGroup, n_frames: int):
    """An ``n_frames`` loop over the camera mesh (the JAX package's
    ``lax.scan`` as a Python loop): this rank's cameras take their frames
    from ``bank`` (n_frames, n_local, ...), and after every frame the
    summaries are all-gathered, so that the next frame's tracked search
    sees the whole fleet (with velocities from the frame before). The
    sampling grids (warp or gather, by ``cfg.bm.resample_mode``) are built
    once per rollout. Returns a dict of per-frame tensors: ``bot_tracked_id``,
    ``bot_valid``, ``bot_pos`` (n_frames, n_local, ...) and ``summary_id``,
    ``summary_pos`` (n_frames, n_cams, ...)."""
    n_local = _local_cameras(cfg, group)
    cam0 = group.rank * n_local

    def rollout(bank, packed_cams, field_scales, field_offsets, colors7, params):
        grids = _stack([
            cfg.bm.make_resample_grid(packed_cams[i], params["max_bot_height"],
                                      field_scales[i], field_offsets[i])
            for i in range(n_local)
        ])
        clip = _shard_param(params["clipping_tolerance"], cam0, n_local)
        gathered = prev = _all_gather(group, _empty_summary_local(cfg, n_local,
                                                                  bank.device))
        outs = []
        for f in range(n_frames):
            tracked = tracked_from_summaries(
                cfg.det, gathered, params["tracked_time_delta"], prev_summaries=prev,
                bot_heights=params.get("bot_heights_yb"))
            blobs, det = _cores(cfg, bank[f], packed_cams, field_scales, field_offsets,
                                colors7, tracked, params, grids, cam0)
            det, summary = finalize_batched(blobs, det, colors7, clip,
                                            params["ball_radius"])
            nxt = _all_gather(group, summary)
            outs.append({
                "bot_tracked_id": det["bot_tracked_id"],
                "bot_valid": det["bot_valid"],
                "bot_pos": det["bot_pos"],
                # (world, n_local, ...) -> (n_cams, ...): the observable
                # summary does not depend on the mesh's layout
                "summary_id": nxt["id"].reshape(cfg.n_cams, -1),
                "summary_pos": nxt["pos"].reshape(cfg.n_cams, -1, 2),
            })
            gathered, prev = nxt, gathered
        return _stack(outs)

    return rollout
