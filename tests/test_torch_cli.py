"""The port's command line, ``meatmodeler_tpu_torch.cli.main``, on the CPU
(``--device cpu``) with ``.npy`` clips: the JAX CLI's ``--json`` payload
keys, the three multi-video schedules, argument errors, and the cv2 case
(the default ``--detector auto`` on a video alone), which is a usage error
naming ``--detector device``, exit code 2."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch import cli
from meatmodeler_tpu_torch import config as config_mod
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence

torch.set_num_threads(2)

SCENE = TurntableScene(image_size=(240, 180), focal=255.0, noise_sigma=1.0)
ARGS = ["--device", "cpu", "--detector", "device", "--max-features", "512", "--max-tracks", "1024", "--max-keyframes", "24"]
# The keys of the JAX CLI's --json payload (meatmodeler_tpu/cli.py).
PAYLOAD_KEYS = {"video", "points", "keyframes", "volume", "volume_carved", "reprojection_rmse", "ply", "timings", "counters"}


@pytest.fixture(autouse=True)
def small_carve_grid(monkeypatch):
    """A 32^3 carve in place of the default grid, which has no flag: the
    command line starts from ``config.DEFAULT_CONFIG``."""
    cfg = config_mod.DEFAULT_CONFIG
    monkeypatch.setattr(
        config_mod, "DEFAULT_CONFIG", dataclasses.replace(cfg, volume=dataclasses.replace(cfg.volume, voxel_resolution=32))
    )


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    paths = []
    for s in (0, 1):
        frames, _, _ = render_sequence(SCENE, 8, seed=s)
        p = d / f"clip{s}.npy"
        np.save(p, frames)
        paths.append(str(p))
    return paths, d


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0
    return buf.getvalue()


def test_single_video_json(clips):
    paths, d = clips
    out = json.loads(_run([paths[0], "-o", str(d / "one"), "--json", *ARGS]))
    assert set(out) == PAYLOAD_KEYS
    assert out["points"] > 50 and out["reprojection_rmse"] < 2.0 and out["keyframes"] >= 3
    assert out["counters"]["keyframes"] == out["keyframes"]
    assert out["ply"] == str(d / "one") + "Cloud.ply"


@pytest.mark.parametrize("schedule", ["sequential", "mesh", "pipelined"])
def test_batch_schedules(clips, schedule):
    paths, d = clips
    out = json.loads(_run([*paths, "-o", str(d / schedule), "--schedule", schedule, "--json", *ARGS]))
    assert isinstance(out, list) and len(out) == 2
    for i, o in enumerate(out):
        assert set(o) == PAYLOAD_KEYS and o["video"] == paths[i]
        assert o["points"] > 50 and np.isfinite(o["reprojection_rmse"])
        assert o["ply"] == f"{d / schedule}_{i}Cloud.ply"


def test_text_output(clips):
    paths, d = clips
    out = _run([paths[1], "-o", str(d / "text"), *ARGS])
    assert "reprojection RMSE:" in out and "cloud written to:" in out and out.startswith("keyframes:")


@pytest.mark.parametrize("argv", [["--detector", "nope"], ["--device", "tpu"], ["--schedule", "ring"]])
def test_bad_flag_value(clips, argv):
    with pytest.raises(SystemExit) as exc:
        cli.main([clips[0][0], *argv])
    assert exc.value.code == 2


@pytest.mark.parametrize("extra", [[], ["--detector", "host"], ["--detector", "device", "--pass1-backend", "host"]])
def test_cv2_detection_is_a_usage_error(clips, capsys, extra):
    """Without known corners the default detector ("auto") and "host", and
    the host pass 1's board hunt, detect with cv2: exit 2 before any work,
    naming the flags that avoid it, and no traceback."""
    with pytest.raises(SystemExit) as exc:
        cli.main([clips[0][0], "--device", "cpu", *extra])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "cv2" in err and "Traceback" not in err
    assert ("--pass1-backend device" if "host" in extra[-1:] and "--pass1-backend" in extra else "--detector device") in err


def test_missing_video_is_a_usage_error():
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu"])
    assert exc.value.code == 2


def test_other_containers_name_cv2(tmp_path):
    with pytest.raises(NotImplementedError, match="cv2"):
        cli.main([str(tmp_path / "clip.mp4"), *ARGS])


def test_cuda_default_raises_without_a_card(clips, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([clips[0][0], "--detector", "device"])


def test_warmup_runs_the_pipeline(capsys):
    """``--warmup W H`` renders a short clip with known corners and runs
    the pipeline on it; a partial run (here, more keyframes than the
    capacity) still exits 0, as in the JAX package."""
    assert cli.main(["--warmup", "160", "120", *ARGS]) == 0
    assert "warmup: done" in capsys.readouterr().err
