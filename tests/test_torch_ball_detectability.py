"""The ball-detectability floor on the port's host models: the counterpart
of tests/test_ball_detectability.py.

``python/ball_detectability.py ball_scores_for_scene`` scores the
reference's ball colour formula at the true ball position of each frame of
a perturbed ``make_dataset.py`` scene. It imports the JAX package's
``CameraModel``, ``ColorState`` and ``load_geometry`` when it runs
(``:60-62``). Here the same function runs a second time with those three
modules resolved to the port's (``models/camera.py``, ``models/colors.py``,
``net/geometry_io.py``): its scores must equal the JAX run's frame by frame
within 1e-6, and hold the JAX test's two bars. The dataset is built once
for the module, as the JAX test builds it.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "python"))

# the modules ball_scores_for_scene imports, and the port's counterparts
MODULES = ("models.camera", "models.colors", "net.geometry_io")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("balldet_torch")
    subprocess.run(
        [sys.executable, str(REPO / "python" / "make_dataset.py"),
         "--out", str(tmp / "data"), "--cams", "2", "--frames", "6"],
        check=True, cwd=str(REPO / "python"),
        env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
    )
    return tmp


def _perturbed(tmp, profile):
    out = tmp / f"pert_{profile}"
    if not out.exists():
        subprocess.run(
            [sys.executable, str(REPO / "python" / "perturb.py"),
             "--data", str(tmp / "data"), "--out", str(out),
             "--profile", profile],
            check=True, cwd=str(REPO / "python"),
            env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
        )
    return out / "synthetic" / "cam0"


def _scores(folder: Path, monkeypatch, port: bool):
    """``ball_scores_for_scene(folder)``; with ``port`` the three modules it
    imports are the port's while it runs."""
    from ball_detectability import ball_scores_for_scene

    with monkeypatch.context() as m:
        if port:
            for name in MODULES:
                m.setitem(sys.modules, f"vision_processor_tpu.{name}",
                          importlib.import_module(f"vision_processor_tpu_torch.{name}"))
        scores, n_above = ball_scores_for_scene(folder)
        if port:
            from vision_processor_tpu.models.camera import CameraModel

            assert CameraModel.__module__ == "vision_processor_tpu_torch.models.camera"
    return scores, n_above


# the JAX test's bars: (profile, least, most frames above min_confidence)
@pytest.mark.parametrize("profile, least, most", [("medium", 0, 1), ("light", 3, 6)])
def test_ball_scores_on_the_port_equal_the_jax_package(dataset, monkeypatch, profile, least,
                                                       most):
    """Each frame's score from the port's models within 1e-6 of the JAX
    package's; the medium profile scores above min_confidence in at most
    one frame (tests/test_ball_detectability.py:50), the light in at least
    three (:64)."""
    folder = _perturbed(dataset, profile)
    jax_scores, jax_above = _scores(folder, monkeypatch, port=False)
    scores, n_above = _scores(folder, monkeypatch, port=True)
    assert len(scores) == len(jax_scores) == 6
    assert scores == pytest.approx(jax_scores, abs=1e-6, rel=0)
    assert n_above == jax_above
    assert least <= n_above <= most, f"{profile}: {scores}"
