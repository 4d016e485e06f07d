"""The port's volume tools against the JAX package's (``tools/``, loaded
by path and left as they are): ``ideal_visual_hull`` equal to the last bit,
and the validation harness's gating, variants and capture on a seeded
synthetic capture (masks equal; hull and carved volume within 1% relative,
the tolerance of ``test_torch_volume.py``)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (the JAX harness imports JAX itself)

from meatmodeler_tpu.config import VolumeConfig as JaxVolumeConfig
from meatmodeler_tpu.io.synthetic import TurntableScene as JaxTurntableScene
from meatmodeler_tpu_torch import pipeline
from meatmodeler_tpu_torch.config import VolumeConfig
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, camera_pose
from meatmodeler_tpu_torch.tools import ideal_visual_hull as t_ivh
from meatmodeler_tpu_torch.tools import volume_validation as t_vv

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
JAX_KEYS = {"pts", "intr", "ext4", "n_kf", "image_size", "sigma", "parallax", "kf_scale", "truth", "vcfg"}
# A capture's volume knobs: the defaults with a 64-voxel carve.
VCFG = np.array([64, 512, 5, 0.029, 0.8, 2.0, 2.5], np.float64)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return _load("ideal_visual_hull"), _load("volume_validation")


# The default scene, and one whose cameras graze the top of the item, so
# part of the voxel grid lies behind them: there the forward-ray test
# (tools/ideal_visual_hull.py:68-77) removes voxels that the line test keeps.
SCENES = {
    "default": {},
    "behind_camera": dict(ellipsoid_center=(3.0, -1.8, -10.0), ring_radius=6.0, ring_height=-2.45, arc_degrees=5.0),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_ideal_visual_hull_matches_jax(jax_tools, scene):
    jivh, _ = jax_tools
    got = t_ivh.ideal_visual_hull(TurntableScene(**SCENES[scene]), 5, 24)
    ref = jivh.ideal_visual_hull(JaxTurntableScene(**SCENES[scene]), 5, 24)
    assert got == ref and got > 0


def test_ideal_visual_hull_forward_ray_matters():
    """On ``behind_camera`` the line test alone would give a larger hull."""
    scene = TurntableScene(**SCENES["behind_camera"])
    c, ax = np.array(scene.ellipsoid_center), np.array(scene.ellipsoid_axes)
    lo, hi = c - ax * 1.3, c + ax * 1.3
    grids = [(np.arange(24) + 0.5) / 24 * (hi[i] - lo[i]) + lo[i] for i in range(3)]
    vox = np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(-1, 3)
    inside = np.ones(len(vox), bool)
    for t in np.linspace(0.0, 1.0, 5):
        rot, tvec = camera_pose(scene, t)
        cam = -rot.T @ tvec
        d, o = (vox - cam) / ax, (cam - c) / ax
        a2, b2, c2 = np.sum(d * d, axis=1), 2.0 * np.sum(d * o, axis=1), np.sum(o * o) - 1.0
        inside &= b2 * b2 - 4.0 * a2 * c2 >= 0
    line_only = float(inside.sum() * np.prod(hi - lo) / 24**3)
    assert t_ivh.ideal_visual_hull(scene, 5, 24) < line_only - 0.1


def test_ideal_visual_hull_decision_record(capsys):
    """The tool's defaults give its docstring's decision record."""
    assert t_ivh.main([]) == 0
    assert capsys.readouterr().out.strip() == "truth 22.619  ideal_visual_hull 36.360  ratio 1.607"


def synthetic_capture(kf_scale: int, seed: int = 0):
    """A capture of the e2e scene's geometry (numpy): a noisy ellipsoid
    cloud with board points and far outliers, ring extrinsics from
    ``camera_pose`` (8 views), K and the image at 1/kf_scale, per-point
    sigma and parallax spanning the gates."""
    rng = np.random.default_rng(seed)
    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    u = rng.normal(size=(700, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    item = u * np.array(scene.ellipsoid_axes) + np.array(scene.ellipsoid_center)
    board = np.c_[rng.uniform(0, 6, 120), np.zeros(120), rng.uniform(0, 4, 120)]
    outliers = rng.uniform([0, -12, -5], [20, -3, 10], size=(10, 3))
    pts = np.concatenate([item, board, outliers])
    pts = (pts + rng.normal(scale=0.03, size=pts.shape)).astype(np.float32)
    ext = []
    for t in np.linspace(0.0, 1.0, 8):
        rot, tvec = camera_pose(scene, t)
        e = np.eye(4)
        e[:3, :3], e[:3, 3] = rot, tvec
        ext.append(e)
    k = scene.intrinsics.copy()
    k[:2] /= kf_scale
    w, h = scene.image_size
    return {
        "pts": pts, "intr": k.astype(np.float32), "ext4": np.stack(ext).astype(np.float32), "n_kf": 8,
        "image_size": np.array([w // kf_scale, h // kf_scale]), "sigma": rng.uniform(0.5, 3.0, len(pts)),
        "parallax": rng.uniform(1.0, 10.0, len(pts)), "kf_scale": kf_scale, "truth": scene.volume, "vcfg": VCFG,
    }


def _jax_vcfg(v):
    r, d, dil, cf, vf, ms, mp = [float(x) for x in v]
    return JaxVolumeConfig(voxel_resolution=int(r), hull_directions=int(d), carve_dilation=int(dil),
                           carve_close_frac=cf, carve_vote_frac=vf, max_point_sigma=ms, min_parallax_deg=mp)


@pytest.mark.parametrize("kf_scale", [1, 2])
def test_masks_for_matches_jax(jax_tools, kf_scale):
    _, jvv = jax_tools
    cap = synthetic_capture(kf_scale)
    got = t_vv.masks_for(cap, t_vv.cfg_of(cap), device="cpu")
    ref = jvv.masks_for(cap, _jax_vcfg(cap["vcfg"]))
    for g, r in zip(got, ref):
        assert g.dtype == bool and 100 < int(r.sum()) < len(r)
        np.testing.assert_array_equal(g, r)
    assert int(got[0].sum()) < int(got[1].sum())  # the gates bite


@pytest.mark.parametrize("kf_scale", [1, 2])
@pytest.mark.parametrize("trim_ref,inflate", [(0, 0.0), (1500, 0.0), (1500, 0.5), (0, 0.5)])
def test_eval_variant_matches_jax(jax_tools, kf_scale, trim_ref, inflate):
    _, jvv = jax_tools
    cap = synthetic_capture(kf_scale)
    got = t_vv.eval_variant(cap, t_vv.cfg_of(cap), "gated", 5, trim_ref=trim_ref, inflate=inflate, device="cpu")
    ref = jvv.eval_variant(cap, _jax_vcfg(cap["vcfg"]), "gated", 5, trim_ref=trim_ref, inflate=inflate)
    assert all(np.isfinite(got)) and ref[0] > 0 and ref[1] > 0
    np.testing.assert_allclose(got, ref, rtol=0.01)


def test_capture_records_the_jax_keys(jax_tools, tmp_path, monkeypatch):
    """``capture_scene`` with ``process`` replaced by a stand-in that calls
    ``_estimate_volume`` once: the capture holds the JAX harness's keys
    (plus the device and the run's own volumes), lands in the cache
    directory given, evaluates in the JAX harness and is read back from the
    cache without running ``process`` again."""
    _, jvv = jax_tools
    syn = synthetic_capture(2)
    calls = []

    def fake_process(frames, config, device):
        calls.append(device)
        t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
        pipeline._estimate_volume(t(syn["pts"]), t(syn["intr"]), t(syn["ext4"]), tuple(syn["image_size"].tolist()),
                                  config, t(syn["sigma"]).float(), t(syn["parallax"]).float(), 2)

    monkeypatch.setattr(pipeline, "process", fake_process)
    scene, _, config = t_vv.validation_scenes()["e2e_400"]
    config = dataclasses.replace(config, volume=VolumeConfig(voxel_resolution=64))
    cap = t_vv.capture_scene("e2e_400", scene, 2, config, device="cpu", cache=tmp_path)
    assert calls == ["cpu"] and (tmp_path / "volval_torch_e2e_400.npz").exists()
    assert JAX_KEYS <= set(cap) and str(cap["device"]) == "cpu"
    assert int(cap["n_kf"]) == 8 and int(cap["kf_scale"]) == 2 and float(cap["truth"]) == scene.volume
    np.testing.assert_array_equal(cap["pts"], syn["pts"])
    np.testing.assert_array_equal(cap["vcfg"], VCFG)
    hull, _ = t_vv.eval_variant(cap, t_vv.cfg_of(cap), "gated", 5, trim_ref=1500)
    assert abs(hull - float(cap["run_hull"])) <= 1e-4 * abs(float(cap["run_hull"]))
    ref, _ = jvv.eval_variant(dict(np.load(tmp_path / "volval_torch_e2e_400.npz")), _jax_vcfg(cap["vcfg"]), "gated",
                              5, trim_ref=1500)
    np.testing.assert_allclose(hull, ref, rtol=0.01)
    again = t_vv.capture_scene("e2e_400", scene, 2, config, device="cpu", cache=tmp_path)
    assert calls == ["cpu"] and set(again) == set(cap)


def test_validation_scenes_match_jax(jax_tools):
    """The JAX harness's four scenes, frame counts and config changes, on
    the device detector."""
    _, jvv = jax_tools
    got, ref = t_vv.validation_scenes(), jvv.validation_scenes()
    assert list(got) == list(ref)
    for name in got:
        (gs, gn, gc), (rs, rn, rc) = got[name], ref[name]
        assert gn == rn and gs.__dict__ == rs.__dict__
        assert (gc.keyframe.threshold, gc.tracks.max_keyframes, gc.tracks.triangulation) == (
            rc.keyframe.threshold, rc.tracks.max_keyframes, rc.tracks.triangulation)
        assert gc.chessboard.detector == "device" and rc.chessboard.detector == "auto"
        assert gc.volume.__dict__ == rc.volume.__dict__


def test_main_refuses_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")

    def refuse(*args, **kwargs):
        raise AssertionError("volume_validation captured without CUDA")

    monkeypatch.setattr(t_vv, "capture_scene", refuse)
    assert t_vv.main([]) == 2
    assert t_vv.main(["--scenes", "e2e_400", "--device", "cuda"]) == 2
