"""On-device frame finishing: color update, id recalculation, ball scoring,
filters and emission projections (PyTorch port).

Counterpart of vision_processor_tpu/models/device_finish.py (reference
src/main.cpp:320-371, src/blobs/colorupdate.cpp:21-120,
src/blobs/hypothesis.cpp:83-94,208-270). The early-exit k-means
``while_loop`` runs its ``iters`` rounds; a finished group is never
updated again, so the result equals the early-exit one. The camera-batched
finisher (the JAX package's vmap) runs the per-camera finisher camera by
camera, so its results are the per-camera ones exactly; on a card
``FinisherGraph`` replays it as one CUDA graph an input signature.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.state import _flatten, _rebuild
from ..utils.timing import RECORDER
from .camera import field2image_packed, goal_boundary_width, image2field_packed
from .detector import _sqnorm, _sqnorm_i, _tables, estimate_bot_ids

_BIG_I32 = 2**30


def pack_field_marks(field, geometry_tolerance: float) -> dict:
    """Static field-marking arrays (numpy float32) for the on-device
    ``balls_at_lines`` test: ``lines`` (L, 4) x1,y1,x2,y2, ``arcs`` (A, 5)
    cx,cy,r,a1,a2, and the ball-emission scalars."""
    lines = np.asarray(
        [[line.p1.x, line.p1.y, line.p2.x, line.p2.y] for line in field.field_lines],
        dtype=np.float32,
    ).reshape(-1, 4)
    arcs = np.asarray(
        [[arc.center.x, arc.center.y, arc.radius, arc.a1, arc.a2]
         for arc in field.field_arcs],
        dtype=np.float32,
    ).reshape(-1, 5)
    return {
        "lines": lines,
        "arcs": arcs,
        "max_d": np.float32(field.line_thickness / 2 + geometry_tolerance),
        "half_len": np.float32(field.field_length / 2 + goal_boundary_width(field)),
        "half_wid": np.float32(field.field_width / 2 + field.boundary_width),
    }


def masked_kmeans2(contrast, vals, mask, c1_init, c2_init, iters: int = 24):
    """Guarded 2-means over the masked rows of ``vals`` (host kmeans2
    semantics, reference src/blobs/kmeans.cpp:20-90). contrast (3,),
    vals (N, 3), mask (N,), inits (3,). Returns (ok, c1, c2) int32."""
    vals = vals.to(torch.int32)
    contrast = contrast.to(torch.int32)
    c1_init = c1_init.to(torch.int32)
    c2_init = c2_init.to(torch.int32)
    n = vals.shape[0]
    dev = vals.device
    m = mask.sum(dtype=torch.int32)

    d_out = _sqnorm_i(vals - contrast)
    out_group = torch.where(mask, d_out, _BIG_I32).amin()

    # pairwise distances via the norm expansion (exact in f32 for small ints)
    vf = vals.to(torch.float32)
    nrm = _sqnorm(vf)
    pair = nrm[:, None] + nrm[None, :] - 2.0 * (vf @ vf.T)
    pmask = mask[:, None] & mask[None, :] & ~torch.eye(n, dtype=torch.bool, device=dev)
    in_group = torch.where(pmask, pair, float(2**30)).amin()
    may_split = (in_group <= out_group.to(torch.float32)) & (m >= 2)

    d1i = _sqnorm_i(vals - c1_init)
    d2i = _sqnorm_i(vals - c2_init)
    c1 = vals.index_select(0, torch.argmin(torch.where(mask, d1i, _BIG_I32)).reshape(1))[0]
    c2 = vals.index_select(0, torch.argmin(torch.where(mask, d2i, _BIG_I32)).reshape(1))[0]
    degenerate = (c1 == c2).all()

    ok = may_split & ~degenerate
    active = ok
    kept = RECORDER.rounds("kmeans", iters)
    for _ in range(iters):
        if kept is not None:
            kept.append(active)
        d1 = _sqnorm_i(vals - c1)
        d2 = _sqnorm_i(vals - c2)
        assign1 = (d1 < d2) & mask
        assign2 = mask & ~assign1
        n1 = assign1.sum(dtype=torch.int32)
        n2 = m - n1
        empty = (n1 == 0) | (n2 == 0)
        ok = ok & ~(empty & active)
        active = active & ~empty
        s1 = torch.where(assign1[:, None], vals, 0).sum(dim=0, dtype=torch.int32)
        s2 = torch.where(assign2[:, None], vals, 0).sum(dim=0, dtype=torch.int32)
        new1 = torch.div(s1, torch.clamp_min(n1, 1), rounding_mode="floor")
        new2 = torch.div(s2, torch.clamp_min(n2, 1), rounding_mode="floor")
        conv = (new1 == c1).all() | (new2 == c2).all()
        c1 = torch.where(active, new1, c1)
        c2 = torch.where(active, new2, c2)
        active = active & ~conv

    split = _sqnorm_i(c1 - c2).to(torch.float32)
    ok = ok & (split >= out_group.to(torch.float32) / 4.0)
    c1 = torch.where(ok, c1, c1_init)
    c2 = torch.where(ok, c2, c2_init)
    return ok, c1, c2


def _blend(ref, old, new, ref_force, hist_force):
    """Reference/history/update blend with the host's integer truncation
    and its boundary nudge (ColorState._blend)."""
    upd = 1.0 - ref_force - hist_force
    mixed = (
        ref_force * ref.to(torch.float32)
        + hist_force * old.to(torch.float32)
        + upd * new.to(torch.float32)
    )
    return torch.trunc(mixed + 1e-3).to(torch.int32)


def balls_at_lines_device(marks, pos):
    """(N,) mask of field positions on a field marking (host
    balls_at_lines, reference src/blobs/colorupdate.cpp:21-40)."""
    max_d = marks["max_d"]
    hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    lines = marks["lines"]
    if lines.shape[0]:
        p1 = lines[:, 0:2]
        v = lines[:, 2:4] - p1
        vv = _sqnorm(v)
        w = pos[:, None, :] - p1[None, :, :]  # (N, L, 2)
        t = (w[..., 0] * v[None, :, 0] + w[..., 1] * v[None, :, 1]) / torch.clamp_min(vv, 1e-9)
        t = torch.where(vv > 0, t.clamp(0.0, 1.0), 0.0)
        d2 = _sqnorm(w - t[..., None] * v[None])
        hit |= (d2 <= max_d * max_d).any(dim=-1)
    arcs = marks["arcs"]
    if arcs.shape[0]:
        rel = pos[:, None, :] - arcs[None, :, 0:2]
        ang = torch.atan2(rel[..., 1], rel[..., 0])
        ang = torch.where(ang < 0, ang + 2 * np.pi, ang)
        r = torch.sqrt(_sqnorm(rel))
        hit |= (
            ((r - arcs[None, :, 2]).abs() <= max_d)
            & (ang >= arcs[None, :, 3])
            & (ang <= arcs[None, :, 4])
        ).any(dim=-1)
    return hit


def update_colors_device(colors7, colors7_ref, bot_valid, bot_id, c5, present,
                         ball_center_colors, ball_mask, at_line_mask,
                         blob_mean_colors, ref_force, hist_force):
    """One frame's adaptive color update (ColorState.update +
    update_field_line, reference src/blobs/colorupdate.cpp:42-120).
    Returns the new (7, 3) int32 table."""
    ci = colors7.to(torch.int32)
    ri = colors7_ref.to(torch.int32)
    orange_o, field_o, yellow_o, blue_o, green_o, pink_o, line_o = (
        ci[0], ci[1], ci[2], ci[3], ci[4], ci[5], ci[6]
    )
    dev = ci.device
    pattern = _tables(8, dev)["patterns"][(bot_id % 16).long()]
    shifts = torch.arange(3, -1, -1, dtype=torch.int32, device=dev)
    bits = (pattern[:, None] >> shifts) & 1
    side_ok = present[:, 1:5] & bot_valid[:, None]
    green_m = side_ok & (bits == 1)
    pink_m = side_ok & (bits == 0)
    sides = c5[:, 1:5]
    green_sum = torch.where(green_m[..., None], sides, 0).sum(dim=(0, 1), dtype=torch.int32)
    pink_sum = torch.where(pink_m[..., None], sides, 0).sum(dim=(0, 1), dtype=torch.int32)
    green_n = green_m.sum(dtype=torch.int32)
    pink_n = pink_m.sum(dtype=torch.int32)

    floordiv = lambda a, b: torch.div(a, torch.clamp_min(b, 1), rounding_mode="floor")
    pink_new = torch.where(
        pink_n > 0,
        _blend(ri[5], pink_o, floordiv(pink_sum, pink_n), ref_force, hist_force),
        pink_o,
    )
    green_new = torch.where(
        green_n > 0,
        _blend(ri[4], green_o, floordiv(green_sum, green_n), ref_force, hist_force),
        green_o,
    )

    # team colors from the center blobs (contrast: the just-updated pink)
    center_mask = bot_valid & present[:, 0]
    ok_yb, y, b = masked_kmeans2(pink_new, c5[:, 0], center_mask, yellow_o, blue_o)
    yellow_new = torch.where(ok_yb, _blend(ri[2], yellow_o, y, ref_force, hist_force),
                             yellow_o)
    blue_new = torch.where(ok_yb, _blend(ri[3], blue_o, b, ref_force, hist_force), blue_o)

    # orange/field from the ball candidates' center-pixel colors
    ok_of, o, f = masked_kmeans2(blue_new, ball_center_colors, ball_mask, orange_o,
                                 field_o)
    orange_new = torch.where(ok_of, _blend(ri[0], orange_o, o, ref_force, hist_force),
                             orange_o)
    field_new = torch.where(ok_of, _blend(ri[1], field_o, f, ref_force, hist_force),
                            field_o)

    # field-line color: mean disc color of candidates on the markings
    n_line = at_line_mask.sum(dtype=torch.int32)
    line_sum = torch.where(at_line_mask[:, None], blob_mean_colors, 0).sum(
        dim=0, dtype=torch.int32)
    line_new = torch.where(n_line > 2, floordiv(line_sum, n_line), line_o)

    return torch.stack(
        [orange_new, field_new, yellow_new, blue_new, green_new, pink_new, line_new]
    )


def ball_color_scores_device(colors7_i, blob_colors):
    """Vectorized ball color score (reference src/blobs/hypothesis.cpp:83-94)."""
    c = blob_colors.to(torch.float32)
    false_orange = _sqnorm(c - colors7_i[1].to(torch.float32))
    orange = _sqnorm(c - colors7_i[0].to(torch.float32))
    field_line = _sqnorm(c - colors7_i[6].to(torch.float32))
    bad = (false_orange <= orange) | (field_line <= orange)
    score = 1.0 - orange / torch.clamp_min(false_orange, 1e-9)
    return torch.where(bad | (false_orange == 0), 0.0, score)


def tracked_veto_device(colors7_i, c5, present, bot_id, tracked_mask):
    """Per-bot color veto for tracked constellations (reference
    src/blobs/hypothesis.cpp:245-270)."""
    dev = c5.device
    blob_amount = present.sum(dim=-1)
    pattern = _tables(8, dev)["patterns"][(bot_id % 16).long()]
    is_blue = bot_id >= 16

    yellow, blue = colors7_i[2], colors7_i[3]
    green, pink = colors7_i[4], colors7_i[5]

    exp0 = torch.where(is_blue[:, None], blue, yellow)
    opp0 = torch.where(is_blue[:, None], yellow, blue)
    shifts = torch.arange(3, -1, -1, dtype=torch.int32, device=dev)
    bits = (pattern[:, None] >> shifts) & 1
    exps = torch.where(bits[..., None] == 1, green, pink)
    opps = torch.where(bits[..., None] == 1, pink, green)
    expected = torch.cat([exp0[:, None], exps], dim=1)
    opposite = torch.cat([opp0[:, None], opps], dim=1)

    d_exp = _sqnorm(c5 - expected)
    d_opp = _sqnorm(c5 - opposite)
    wrong = present & (d_opp - d_exp <= 0)
    veto = (blob_amount < 2) | wrong.any(dim=-1)
    return veto & tracked_mask


def camera_edge_cut(packed_cam, ball_img, ball_pos, marks, max_bot_height,
                    min_cam_edge_distance):
    """Camera-edge ball filter (reference src/main.cpp:160-192)."""
    w = packed_cam[16]
    h = packed_cam[17]
    n = ball_img.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=ball_img.device)
    borders = torch.stack(
        [
            torch.stack([zeros, ball_img[:, 1]], dim=1),
            torch.stack([torch.zeros_like(zeros) + (w - 1.0), ball_img[:, 1]], dim=1),
            torch.stack([ball_img[:, 0], zeros], dim=1),
            torch.stack([ball_img[:, 0], torch.zeros_like(zeros) + (h - 1.0)], dim=1),
        ],
        dim=1,
    )  # (N, 4, 2)
    bpos = image2field_packed(packed_cam, borders, max_bot_height)[..., :2]
    inside = (
        (bpos[..., 0].abs() <= marks["half_len"])
        & (bpos[..., 1].abs() <= marks["half_wid"])
        & torch.isfinite(bpos).all(dim=-1)
    )
    d2 = _sqnorm(bpos - ball_pos[:, None, :])
    return (inside & (d2 < min_cam_edge_distance**2)).any(dim=1)


def finish_on_device(blobs, det, colors7, colors7_ref, packed_cam, marks, params):
    """Device-side frame finishing in the host path's order (assemble bots
    and ball candidates, adaptive color update, recalculation, ball filters,
    emission projections). Returns the ``fin`` dict."""
    max_bot_height = params["max_bot_height"]
    ball_radius = params["ball_radius"]

    blob_color = blobs["color"].to(torch.int32)
    blob_center = blobs["center"].to(torch.int32)

    bot_valid = det["bot_valid"]
    idx = det["bot_blob_idx"]
    present = idx >= 0
    safe = torch.clamp_min(idx, 0).long()
    c5 = blob_color[safe]  # (B, 5, 3)
    bot_id = det["bot_id_est"].to(torch.int32)
    tracked_mask = det["bot_tracked_id"] >= 0

    ball_mask = blobs["valid"] & ~det["ball_clipped"]

    ball_pos = blobs["field_pos"].to(torch.float32)
    pos3 = torch.cat(
        [ball_pos, torch.zeros_like(ball_pos[:, :1]) + max_bot_height], dim=-1
    )
    ball_img = field2image_packed(packed_cam, pos3)
    ball_world = image2field_packed(packed_cam, ball_img, ball_radius)
    ground = torch.nan_to_num(ball_world[..., :2], nan=1e9)
    at_line = balls_at_lines_device(marks, ground) & ball_mask

    colors_new = update_colors_device(
        colors7, colors7_ref, bot_valid, bot_id, c5, present, blob_center,
        ball_mask, at_line, blob_color, params["reference_force"],
        params["history_force"],
    )
    colors_new_f = colors_new.to(torch.float32)

    bot_id_new = estimate_bot_ids(det, blobs["color"], colors_new_f)
    veto = tracked_veto_device(colors_new, c5, present, bot_id, tracked_mask)
    bot_score = torch.where(veto, 0.0, det["bot_score"])
    ball_scores = ball_color_scores_device(colors_new, blob_color)

    keep = (
        ball_mask
        & (ball_scores > params["min_confidence"])
        & (blobs["score"] > params["min_score"])
    )
    cut = camera_edge_cut(packed_cam, ball_img, ball_pos, marks, max_bot_height,
                          params["min_cam_edge_distance"])
    keep = keep & ~cut

    bpos3 = torch.cat(
        [det["bot_pos"].to(torch.float32),
         torch.zeros_like(det["bot_pos"][:, :1]) + max_bot_height],
        dim=-1,
    )
    bot_img = field2image_packed(packed_cam, bpos3)
    heights = torch.where(bot_id_new >= 16, params["bot_heights_yb"][1],
                          params["bot_heights_yb"][0])
    bot_world = image2field_packed(packed_cam, bot_img, heights)

    return {
        "colors7": colors_new_f,
        "bot_valid": bot_valid,
        "bot_id": bot_id_new,
        "bot_score": bot_score,
        "bot_orientation": det["bot_orientation"],
        "bot_world": bot_world,
        "bot_pixel": bot_img,
        "ball_valid": keep,
        "ball_score": ball_scores,
        "ball_world": ball_world,
        "ball_pixel": ball_img,
    }


# ---------------------------------------------------------------------------
# camera-batched finisher
# ---------------------------------------------------------------------------

_FIN_PARAM_KEYS = (
    "max_bot_height",
    "ball_radius",
    "reference_force",
    "history_force",
    "min_confidence",
    "min_score",
    "min_cam_edge_distance",
    "bot_heights_yb",
)


def stack_finish_params(params: dict, n_cams: int) -> dict:
    """The finisher's params with a leading camera axis: shared scalars
    replicate; per-camera (N,) tunables pass through."""
    out = {}
    for k in _FIN_PARAM_KEYS:
        v = torch.as_tensor(params[k], dtype=torch.float32)
        if k == "bot_heights_yb":
            out[k] = torch.broadcast_to(v, (n_cams, 2))
        elif v.dim() == 0:
            out[k] = torch.broadcast_to(v, (n_cams,))
        else:
            out[k] = v
    return out


def _cam(tree: dict, c: int) -> dict:
    return {k: v[c] for k, v in tree.items()}


def finish_on_device_batched(blobs, det, colors7, colors7_refs, packed_cams, marks,
                             params):
    """``finish_on_device`` over a leading camera axis on every input
    (``params`` from ``stack_finish_params``), one camera at a time; the
    outputs are stacked. The finisher reads nothing back to the host, so
    the loop only enqueues."""
    outs = []
    for c in range(packed_cams.shape[0]):
        outs.append(finish_on_device(
            _cam(blobs, c), _cam(det, c), colors7[c], colors7_refs[c], packed_cams[c],
            _cam(marks, c), _cam(params, c)))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def finish_signature(args) -> tuple:
    """The key of a captured finisher: every input leaf's path, shape, dtype
    and device, and the recorder's mode (off, on, on with device counting),
    which decides whether the loops keep their ``active`` tensors."""
    return (tuple((p, tuple(t.shape), t.dtype, t.device) for p, t in _flatten(args)),
            RECORDER.on, RECORDER.device_counting)


class _CapturedFinisher:
    """One signature's CUDA graph of ``finish_on_device_batched``, its static
    input buffers and outputs, and the k-means rounds it logged."""

    def __init__(self, args, device):
        self._static = {p: torch.empty(t.shape, dtype=t.dtype, device=device)
                        for p, t in _flatten(args)}
        self._args = _rebuild(args, self._static)
        self._load(args)
        # warm up on the capture's stream (cuBLAS's handle, the detection
        # tables), then capture there
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), RECORDER.collect_rounds():
            finish_on_device_batched(*self._args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with RECORDER.collect_rounds() as rounds, torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            self._out = finish_on_device_batched(*self._args)
        self._rounds = rounds

    def _load(self, args) -> None:
        for p, t in _flatten(args):
            self._static[p].copy_(t)

    def replay(self, args) -> dict:
        self._load(args)
        self.graph.replay()
        RECORDER.replay_rounds(self._rounds)
        # clones: the caller may read them after the next replay
        return {k: v.clone() for k, v in self._out.items()}


class FinisherGraph:
    """``finish_on_device_batched`` replayed as one CUDA graph an input
    signature (``finish_signature``), where launching its thousands of
    small operations one by one would hold the host.

    On a CUDA device, outside another stream capture, the first call of a
    signature warms the finisher up and captures it; every call copies its
    inputs into that signature's static buffers, replays the graph and
    returns clones of the outputs. Anywhere else it calls
    ``finish_on_device_batched``. The graph runs the eager call's kernels
    in its order, so the outputs are bit-equal. ``captures``, ``replays``
    and ``eager`` count the calls of each kind, as do the recorder's
    ``finisher.graph.capture``, ``finisher.graph.replay`` and
    ``finisher.eager``. A step builds its own, so a rebuilt step drops its
    graphs."""

    def __init__(self):
        self.captures = self.replays = self.eager = 0
        self._graphs = {}

    def __call__(self, blobs, det, colors7, colors7_refs, packed_cams, marks, params):
        args = (blobs, det, colors7, colors7_refs, packed_cams, marks, params)
        device = packed_cams.device
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            self.eager += 1
            RECORDER.count("finisher.eager", 1)
            return finish_on_device_batched(*args)
        key = finish_signature(args)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _CapturedFinisher(args, device)
            self.captures += 1
            RECORDER.count("finisher.graph.capture", 1)
        self.replays += 1
        RECORDER.count("finisher.graph.replay", 1)
        return graph.replay(args)
