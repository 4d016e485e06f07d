"""The port stands alone: no module of ``meatmodeler_tpu_torch`` (nor
``chip_smoke.py``) imports the JAX package or ``bench``, and its own copies
of the reference's host modules give the reference's results: configs
field for field, PLY bytes, checkpoints, the native host ops and pass-1
scan, frame sources and the numpy scene renderer."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from meatmodeler_tpu import config as jconfig
from meatmodeler_tpu.io import native_ops as jnative_ops
from meatmodeler_tpu.io import native_pass1 as jnative_pass1
from meatmodeler_tpu.io import ply as jply
from meatmodeler_tpu.io import synthetic as jsynthetic
from meatmodeler_tpu.io import video as jvideo
from meatmodeler_tpu.io import y4m as jy4m
from meatmodeler_tpu.utils import checkpoint as jcheckpoint
from meatmodeler_tpu_torch import config as tconfig
from meatmodeler_tpu_torch.io import _native_build, native_ops, native_pass1, ply, synthetic, video, y4m
from meatmodeler_tpu_torch.testing import from_fields
from meatmodeler_tpu_torch.tools.profile_headline import detector_config, headline_config
from meatmodeler_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "meatmodeler_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    """Top-level module names that ``path`` imports (absolute imports)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package_or_bench(path):
    assert not _imported_roots(path) & {"meatmodeler_tpu", "bench", "jax", "jaxlib", "cv2"}


@pytest.mark.parametrize(
    "module",
    ["geometry/ransac.py", "two_view.py", "utils/alignment.py", "parallel/batch.py", "parallel/pipelined.py",
     "odometry.py", "cli.py"],
)
def test_scan_covers_the_marker_free_modules(module):
    assert REPO / "meatmodeler_tpu_torch" / module in PORT_FILES


_PROCESS_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import torch
torch.set_num_threads(1)
from meatmodeler_tpu_torch import process
from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, KeyframeConfig, OrbConfig, MatcherConfig, TrackConfig
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
frames, _, corners = render_sequence(scene, 24, seed=0)
config = dataclasses.replace(
    DEFAULT_CONFIG,
    keyframe=dataclasses.replace(KeyframeConfig(), max_corners=256, threshold=0.02),
    orb=OrbConfig(num_features=512, num_levels=2), matcher=MatcherConfig(max_matches=512),
    tracks=TrackConfig(max_tracks=1024, max_keyframes=32), frame_chunk=8,
    pass1_backend="host", pass2_enhance="grey",
)
res = process(frames, path=sys.argv[1], config=config, known_corners=corners, device="cpu")
assert res.metrics["counters"]["keyframes"] >= 3 and np.isfinite(res.points).all(), res.metrics
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("meatmodeler_tpu", "bench", "jax", "jaxlib", "cv2"))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_process_loads_nothing_of_the_jax_package(tmp_path):
    """A CPU ``process`` through every stage (host pass 1, PLY, volume)
    leaves no ``meatmodeler_tpu`` module in ``sys.modules``."""
    proc = subprocess.run(
        [sys.executable, "-c", _PROCESS_SCRIPT, str(tmp_path / "run")],
        cwd=str(REPO), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert (tmp_path / "runCloud.ply").exists()


# --- configs ---------------------------------------------------------------


def _jax_detector_config(config):
    return dataclasses.replace(
        config, pass1_backend="device", pass2_enhance="bgr_lab",
        chessboard=dataclasses.replace(config.chessboard, detector="device"),
    )


@pytest.mark.parametrize(
    "port,ref",
    [
        (lambda: tconfig.DEFAULT_CONFIG, lambda: jconfig.DEFAULT_CONFIG),
        (headline_config, bench.bench_config),
        (lambda: detector_config(headline_config()), lambda: _jax_detector_config(bench.bench_config())),
    ],
    ids=["default", "headline", "headline_detector"],
)
def test_configs_equal_the_reference(port, ref):
    assert type(port()).__module__ == "meatmodeler_tpu_torch.config"
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


@pytest.mark.parametrize(
    "name",
    ["ClaheConfig", "KeyframeConfig", "OrbConfig", "MatcherConfig", "ChessboardConfig", "SolverConfig",
     "TrackConfig", "VolumeConfig", "PipelineConfig"],
)
def test_config_classes_match_field_for_field(name):
    def fields(cls):
        return [
            (f.name, dataclasses.asdict(f.default) if dataclasses.is_dataclass(f.default) else f.default)
            for f in dataclasses.fields(cls)
        ]

    assert fields(getattr(tconfig, name)) == fields(getattr(jconfig, name))


def test_from_fields_round_trips():
    ref = bench.bench_config()
    port = from_fields(ref)
    assert isinstance(port, tconfig.PipelineConfig) and isinstance(port.chessboard, tconfig.ChessboardConfig)
    assert port == headline_config()
    assert dataclasses.asdict(from_fields(port)) == dataclasses.asdict(ref)
    assert from_fields(jconfig.SolverConfig(ftol=1e-7)) == tconfig.SolverConfig(ftol=1e-7)


@pytest.mark.parametrize(
    "cls,kwargs",
    [
        ("PipelineConfig", dict(pass2_enhance="lab")),
        ("PipelineConfig", dict(pass1_backend="gpu")),
        ("ChessboardConfig", dict(detector="cv2")),
        ("TrackConfig", dict(triangulation="pairs")),
    ],
)
def test_bad_choice_raises_the_same_error(cls, kwargs):
    with pytest.raises(ValueError) as ref:
        getattr(jconfig, cls)(**kwargs)
    with pytest.raises(ValueError) as port:
        getattr(tconfig, cls)(**kwargs)
    assert str(port.value) == str(ref.value)


# --- host io ---------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False])
def test_ply_bytes_identical(tmp_path, binary):
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    a = ply.write_ply(tmp_path / "port.ply", pts, binary=binary)
    b = jply.write_ply(tmp_path / "ref.ply", pts, binary=binary)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    np.testing.assert_array_equal(ply.read_ply(a), jply.read_ply(a))


def test_checkpointer_round_trips(tmp_path):
    arrays = dict(greys=np.arange(24, dtype=np.float32).reshape(2, 3, 4), frames_total=np.int64(7))
    ck = checkpoint.StageCheckpointer(str(tmp_path))
    assert ck.enabled and not ck.has("keyframes")
    ck.save("keyframes", **arrays)
    assert ck.has("keyframes")
    for loaded in (ck.load("keyframes"), jcheckpoint.StageCheckpointer(str(tmp_path)).load("keyframes")):
        assert sorted(loaded) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(loaded[k], v)
    off = checkpoint.StageCheckpointer(None)
    off.save("x", a=np.zeros(1))
    assert not off.enabled and not off.has("x")


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_bgr_to_grey_down_identical(scale):
    frames = np.random.default_rng(scale).integers(0, 256, size=(3, 37, 53, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native_ops.bgr_to_grey_down(frames, scale), jnative_ops.bgr_to_grey_down(frames, scale))


def test_native_libraries_build_into_the_port_build_dir():
    native_ops.bgr_to_grey_down(np.zeros((1, 4, 4, 3), np.uint8))
    assert native_ops.native_available() and native_pass1.host_pass1_available()
    for lib in (native_ops._native, native_pass1._native, y4m._native):
        assert lib._lib_path.parent == _native_build.BUILD_DIR
        assert _native_build.BUILD_DIR == REPO / "build" / "meatmodeler_tpu_torch"


def _chunks(source, n):
    return [c.copy() for c in source.chunks(n)]


@pytest.mark.parametrize("suffix", [".y4m", ".npy", "array"])
def test_frame_source_chunks_identical(tmp_path, suffix):
    frames, _, _ = synthetic.render_sequence(synthetic.TurntableScene(image_size=(64, 48), focal=60.0), 5, seed=2)
    if suffix == ".y4m":
        src = tmp_path / "clip.y4m"
        y4m.write_y4m(src, frames)
        jy4m.write_y4m(tmp_path / "ref.y4m", frames)
        assert src.read_bytes() == (tmp_path / "ref.y4m").read_bytes()
        np.testing.assert_array_equal(y4m.read_y4m(src), jy4m.read_y4m(src))
    elif suffix == ".npy":
        src = tmp_path / "clip.npy"
        np.save(src, frames[..., 0])  # grey: the source repeats it to BGR
    else:
        src = frames
    port, ref = _chunks(video.FrameSource(src), 2), _chunks(jvideo.FrameSource(src), 2)
    assert [c.shape for c in port] == [c.shape for c in ref] == [(2, 48, 64, 3), (2, 48, 64, 3), (1, 48, 64, 3)]
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def test_frame_source_refuses_other_containers(tmp_path):
    with pytest.raises(NotImplementedError, match="cv2"):
        video.FrameSource(tmp_path / "clip.mp4")


def test_host_pass1_scanner_identical():
    """Flags and enhanced frames of the native scan through both bindings,
    over two chunks of a small rendered clip."""
    from test_pipeline import TEST_CONFIG

    frames, _, _ = jsynthetic.render_sequence(jsynthetic.TurntableScene(image_size=(200, 150), focal=210.0), 16, seed=0)
    greys = jnative_ops.bgr_to_grey_down(frames, 1)
    port = native_pass1.HostPass1Scanner(from_fields(TEST_CONFIG), 150, 200, full_width=200)
    ref = jnative_pass1.HostPass1Scanner(TEST_CONFIG, 150, 200, full_width=200)
    for i, chunk in enumerate((greys[:8], greys[8:])):
        boot = 0 if i == 0 else -1
        (fp, ep), (fr, er) = port.scan(chunk, bootstrap_at=boot), ref.scan(chunk, bootstrap_at=boot)
        np.testing.assert_array_equal(fp, fr)
        np.testing.assert_array_equal(ep, er)
    assert port.initialized and ref.initialized


# --- synthetic scene -------------------------------------------------------


def test_camera_pose_and_render_frame_identical():
    scene_t = synthetic.TurntableScene(image_size=(80, 60), focal=80.0, ground_texture=3.0)
    scene_j = jsynthetic.TurntableScene(image_size=(80, 60), focal=80.0, ground_texture=3.0)
    assert dataclasses.asdict(scene_t) == dataclasses.asdict(scene_j)
    assert scene_t.volume == scene_j.volume
    np.testing.assert_array_equal(scene_t.board_corners_3d(), scene_j.board_corners_3d())
    for t in (0.0, 0.37, 1.0):
        rot_t, tvec_t = synthetic.camera_pose(scene_t, t)
        rot_j, tvec_j = jsynthetic.camera_pose(scene_j, t)
        np.testing.assert_array_equal(rot_t, rot_j)
        np.testing.assert_array_equal(tvec_t, tvec_j)
        a = synthetic._render_frame(scene_t, rot_t, tvec_t, np.random.default_rng(4))
        b = jsynthetic._render_frame(scene_j, rot_j, tvec_j, np.random.default_rng(4))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(synthetic._tint(a), jsynthetic._tint(b))


def test_numpy_render_sequence_identical():
    scene_t = synthetic.TurntableScene(image_size=(64, 48), focal=60.0)
    scene_j = jsynthetic.TurntableScene(image_size=(64, 48), focal=60.0)
    ft, pt, ct = synthetic.render_sequence(scene_t, 4, seed=5)
    fj, pj, cj = jsynthetic.render_sequence(scene_j, 4, seed=5)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pt, pj, atol=1e-5)  # rotation vectors by each package's so3.log
    assert torch.is_tensor(torch.from_numpy(ft))
