"""The port's small host components against the JAX package's, on the same
inputs: calib/lines.py ``line_intersections`` and ``find_outer_edges``,
io/camera.py ``open_camera`` with an unknown driver,
models/camera.py ``CameraModel.ensure_size`` and models/kmeans.py
``kmeans2`` (the counterparts of tests/test_misc_coverage.py:9, :125,
tests/test_camera.py:63 and tests/test_components.py:16-41)."""
from __future__ import annotations

import copy
import importlib

import numpy as np
import pytest

PKGS = ("vision_processor_tpu", "vision_processor_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _box_lines():
    """tests/test_misc_coverage.py:9's four sides of a 100 x 80 box."""
    return [(np.array([0.0, 0.0]), np.array([100.0, 0.0])),
            (np.array([0.0, 80.0]), np.array([100.0, 80.0])),
            (np.array([0.0, 0.0]), np.array([0.0, 80.0])),
            (np.array([100.0, 0.0]), np.array([100.0, 80.0]))]


def _random_lines(seed: int, n: int):
    """Seeded segments over a 640 x 480 image, one pair parallel."""
    rng = np.random.default_rng(seed)
    lines = [(rng.uniform(-50, 690, 2), rng.uniform(-50, 530, 2)) for _ in range(n)]
    a, b = lines[0]
    lines.append((a + 7.0, b + 7.0))
    return lines


@pytest.mark.parametrize("case", ["box", "seed 9", "seed 10"])
def test_line_intersections_and_outer_edges_equal_the_jax_package(case):
    """The same segments through both packages' ``line_intersections`` (at
    two distance margins) and ``find_outer_edges``: equal points, in the
    same order; the box gives its 4 corners and the quadrilateral of
    them, as the JAX test wants."""
    lines = _box_lines() if case == "box" else _random_lines(int(case[-2:]), 5)
    width, height = (100, 80) if case == "box" else (640, 480)
    for margin in (1.0, 0.1):
        got = [_mod(pkg, "calib.lines").line_intersections(lines, width, height, margin)
               for pkg in PKGS]
        assert len(got[1]) == len(got[0])
        for p, q in zip(*got):
            np.testing.assert_array_equal(p, q)
        edges = [_mod(pkg, "calib.lines").find_outer_edges(pts)
                 for pkg, pts in zip(PKGS, got)]
        assert len(edges[1]) == len(edges[0])
        for p, q in zip(*edges):
            np.testing.assert_array_equal(p, q)
        if case == "box":
            assert len(got[1]) == 4 and len(edges[1]) == 4
            assert sorted(round(p[0]) for p in edges[1]) == [0, 0, 100, 100]
        else:
            assert len(got[1]) >= 4
    parallel = [_mod(pkg, "calib.lines").line_line_intersection(*_box_lines()[:2])
                for pkg in PKGS]
    assert not np.isfinite(parallel[1]).any() and not np.isfinite(parallel[0]).any()


@pytest.mark.parametrize("driver", ["NOPE", "V4L", "spinnaker2", "Basler"])
def test_open_camera_refuses_an_unknown_driver_as_the_jax_package(driver):
    """tests/test_misc_coverage.py:125: an unknown driver name raises the
    same exception type with the same message in both packages."""
    raised = []
    for pkg in PKGS:
        section = _mod(pkg, "utils.config").CameraSection(driver=driver)
        with pytest.raises(Exception) as info:
            _mod(pkg, "io.camera").open_camera(section)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[1] == raised[0]
    assert raised[1][0] == "ValueError"


@pytest.mark.parametrize("size", [(480, 360), (960, 720), (1920, 1440), (1224, 1024)])
def test_ensure_size_rescales_as_the_jax_package(overhead_model, size):
    """tests/test_camera.py:63 on both packages' models of the same camera:
    every attribute equal after ``ensure_size`` (the same size is a no-op;
    half the width halves the focal length and the principal point)."""
    models = []
    for pkg in PKGS:
        CameraModel = _mod(pkg, "models.camera").CameraModel
        m = CameraModel(focal_length=overhead_model.focal_length,
                        principal_point=overhead_model.principal_point.copy(),
                        distortion_k2=overhead_model.distortion_k2,
                        pos=overhead_model.pos.copy(), quat=overhead_model.quat.copy(),
                        size=overhead_model.size.copy())
        m.ensure_size(np.array(size))
        models.append(m)
    for key in ("focal_length", "principal_point", "distortion_k2", "pos", "quat", "size"):
        a, b = (np.asarray(getattr(m, key)) for m in models)
        assert b.dtype == a.dtype, key
        np.testing.assert_array_equal(b, a, err_msg=key)
    ref = copy.deepcopy(overhead_model)
    ref.ensure_size(np.array(size))
    assert models[1].focal_length == pytest.approx(900.0 * size[0] / 960.0)
    np.testing.assert_allclose(models[1].principal_point, ref.principal_point)


def _kmeans_cases() -> dict:
    """tests/test_components.py:16-41's cases, then seeded ones."""
    cases = {
        "clear clusters": ([120, 120, 120], [[10, 10, 10], [12, 9, 11], [200, 50, 60],
                                             [205, 52, 58]], [0, 0, 0], [255, 80, 80]),
        "tight group": ([11, 10, 10], [[10, 10, 10], [200, 200, 200]], [0, 0, 0],
                        [255, 255, 255]),
        "one value": ([0, 0, 0], [[1, 2, 3]], [0, 0, 0], [1, 1, 1]),
        "degenerate": ([200, 200, 200], [[50, 50, 50]] * 3 + [[52, 50, 50]], [10, 10, 10],
                       [90, 90, 90]),
        "no values": ([50, 50, 50], [], [0, 0, 0], [255, 255, 255]),
    }
    rng = np.random.default_rng(41)
    for k in range(6):
        n = int(rng.integers(2, 12))
        centres = rng.integers(0, 256, (2, 3))
        vals = centres[rng.integers(0, 2, n)] + rng.integers(-8, 9, (n, 3))
        cases[f"seed {k}"] = (rng.integers(0, 256, 3).tolist(),
                              np.clip(vals, 0, 255).tolist(),
                              rng.integers(0, 256, 3).tolist(),
                              rng.integers(0, 256, 3).tolist())
    return cases


KMEANS_CASES = _kmeans_cases()
# tests/test_components.py's outcomes: (updated, c1, c2), None where it checks none
KMEANS_WANT = {
    "clear clusters": (True, [11, 9, 10], [202, 51, 59]),
    "tight group": (False, None, None),
    "one value": (False, None, None),
    "degenerate": (False, [10, 10, 10], [90, 90, 90]),
}


@pytest.mark.parametrize("case", list(KMEANS_CASES))
def test_kmeans2_equals_the_jax_package(case):
    """The host ``kmeans2`` of both packages on the same contrast, values
    and seeds: the same (updated, c1, c2), the inputs unchanged; the JAX
    test's outcomes where it states them."""
    contrast, vals, c1, c2 = KMEANS_CASES[case]
    got = []
    for pkg in PKGS:
        values = [np.array(v) for v in vals]
        seeds = np.array(c1), np.array(c2)
        ok, n1, n2 = _mod(pkg, "models.kmeans").kmeans2(np.array(contrast), values, *seeds)
        np.testing.assert_array_equal(seeds[0], c1)
        np.testing.assert_array_equal(seeds[1], c2)
        got.append((bool(ok), np.asarray(n1).tolist(), np.asarray(n2).tolist()))
    assert got[1] == got[0]
    want = KMEANS_WANT.get(case)
    if want is not None:
        assert got[1][0] == want[0]
        for w, g in zip(want[1:], got[1][1:]):
            if w is not None:
                assert g == w
