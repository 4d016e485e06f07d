"""The port's threaded host keyframe scan (``meatmodeler_tpu_torch/native/
pass1.cpp``) against ``native/pass1.cpp``, the serial scan, built through the
JAX package's binding: bit for bit, at 1, 2 and 3 threads and at the cores
the process may use.

Each case runs both scanners over the same chunks and compares, after every
chunk, the flags, the CLAHE'd frame at every index and the carried state
(previous frame, points, mask, accumulated error and displacement)."""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from meatmodeler_tpu.io import native_pass1 as jnative_pass1
from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, KeyframeConfig, MatcherConfig, OrbConfig, TrackConfig, VolumeConfig
from meatmodeler_tpu_torch.io import native_ops, native_pass1
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.tools.profile_headline import headline_config

# The board cells' pass-1 operating point: 320x180 greys from a clip 6x wider
# (here rendered at 640x360 and decimated by 2), the headline keyframe and
# CLAHE settings, 32-frame chunks.
CONFIG = headline_config()
SCENE = TurntableScene(image_size=(640, 360), focal=500.0, noise_sigma=1.5)
FULL_WIDTH = 1920


@pytest.fixture(scope="module")
def greys():
    frames, _, _ = render_sequence(SCENE, 96, seed=5)
    return native_ops.bgr_to_grey_down(frames, 2)


def _tiled(shape, seed):
    """A frame of one 16x16 random patch repeated: its Shi-Tomasi responses
    tie from cell to cell."""
    patch = np.random.default_rng(seed).integers(0, 256, size=(16, 16)).astype(np.uint8)
    h, w = shape
    return np.tile(patch, (h // 16 + 1, w // 16 + 1))[:h, :w]


def _case(name, greys):
    """(chunks, bootstrap_at of each chunk) of a case."""
    if name == "known_chunks":
        return [greys[i : i + 32] for i in range(0, 96, 32)], [0, -1, -1]
    if name == "batch_call":
        return [greys[:60]], [0]
    if name == "mid_chunk_bootstrap":
        return [greys[:32], greys[32:64]], [13, -1]
    if name == "one_frame_chunks":
        return [greys[:1], greys[1:2], greys[2:20], greys[20:21]], [0, -1, -1, -1]
    if name == "blank_frame":
        clip = greys[:24].copy()
        clip[6:9] = 0  # tracked into a blank frame: fires, reseeds nothing
        return [clip[:16], clip[16:]], [0, -1]
    if name == "tied_responses":
        clip = greys[:20].copy()
        clip[0] = _tiled(clip.shape[1:], 0)
        clip[9] = _tiled(clip.shape[1:], 1)
        return [clip[:1], clip[1:]], [0, -1]
    raise ValueError(name)


CASES = ["known_chunks", "batch_call", "mid_chunk_bootstrap", "one_frame_chunks", "blank_frame", "tied_responses"]


def _state(scanner):
    return [scanner._prev, scanner._pts, scanner._mask, scanner._acc, scanner._acc_flow]


@pytest.mark.parametrize("threads", [1, 2, 3, "allowed"])
@pytest.mark.parametrize("case", CASES)
def test_threaded_scan_is_the_serial_scan(greys, case, threads):
    n = len(os.sched_getaffinity(0)) if threads == "allowed" else threads
    chunks, boots = _case(case, greys)
    h, w = chunks[0].shape[1:]
    port = native_pass1.HostPass1Scanner(CONFIG, h, w, full_width=FULL_WIDTH, _threads=n)
    ref = jnative_pass1.HostPass1Scanner(CONFIG, h, w, full_width=FULL_WIDTH)
    fired, masks = 0, []
    for chunk, boot in zip(chunks, boots):
        (fp, ep), (fr, er) = port.scan(chunk, bootstrap_at=boot), ref.scan(chunk, bootstrap_at=boot)
        np.testing.assert_array_equal(fp, fr)
        np.testing.assert_array_equal(ep, er)
        for a, b in zip(_state(port), _state(ref)):
            np.testing.assert_array_equal(a, b)
        fired += int(fr.sum())
        masks.append(port._mask.copy())
    if case in ("known_chunks", "batch_call"):
        assert fired >= 3
    if case == "blank_frame":
        assert not masks[-1].any()
    if case == "tied_responses":  # seeded on the tiled frame
        assert masks[0].all()


def test_concurrent_scans_are_the_serial_scan(greys):
    """Twelve scans at once from Python threads (more than the cores), each
    asking for the pool: the one that holds it and those that run alone on
    their thread all give the serial scan's flags and frames."""
    chunks = [greys[i : i + 32] for i in range(0, 96, 32)]
    h, w = greys.shape[1:]

    def run(scanner):
        return [scanner.scan(c, bootstrap_at=0 if i == 0 else -1) for i, c in enumerate(chunks)]

    ref = run(jnative_pass1.HostPass1Scanner(CONFIG, h, w, full_width=FULL_WIDTH))
    allowed = len(os.sched_getaffinity(0))
    scanners = [
        native_pass1.HostPass1Scanner(CONFIG, h, w, full_width=FULL_WIDTH, _threads=n) for n in [allowed, 2, 3] * 4
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(len(scanners)) as pool:
            futures = [pool.submit(run, sc) for sc in scanners]
            results = [f.result(timeout=600) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for got in results:
        for (fp, ep), (fr, er) in zip(got, ref):
            np.testing.assert_array_equal(fp, fr)
            np.testing.assert_array_equal(ep, er)


def test_scan_counts_its_threads_under_process():
    """A ``process`` call with known corners runs the host pass 1 and adds
    the threads each scan ran on to ``host_scan_threads`` of its span."""
    torch.set_num_threads(2)
    config = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(KeyframeConfig(), max_corners=256, threshold=0.02),
        orb=OrbConfig(num_features=512, num_levels=2),
        matcher=MatcherConfig(max_matches=512),
        tracks=TrackConfig(max_tracks=1024, max_keyframes=32),
        volume=VolumeConfig(voxel_resolution=32),
        frame_chunk=8,
        pass1_backend="host",
        pass2_enhance="grey",
    )
    frames, _, corners = render_sequence(TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0), 24, seed=0)
    res = process(frames, config=config, known_corners=corners, device="cpu")
    counters = res.metrics["counters"]
    assert counters["host_scan_threads:pass1_keyframes/host_scan"] == 3 * len(os.sched_getaffinity(0))
