"""Time and profile the port's headline runs on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.profile_headline [--warm-runs 10] [--out FILE]

It renders the headline clip on the card (300 frames, 1920x1080, seed 0,
with its ground-truth board corners) and profiles two paths through
``process``:

  known: ``headline_config()`` (host C++ pass 1, grey pass-2 enhance)
    with the renderer's board corners as ``known_corners``;
  detector: the board-finding default path, ``detector_config`` of the
    same config (device pass 1, ``bgr_lab`` enhance, the device chessboard
    detector) with no ``known_corners``.

Each path runs four ways:

  1. cold: the first ``process`` of the process (the CLAHE library is built
     first if it is missing);
  2. warm, ``--warm-runs`` times: e2e seconds (median and quartiles) and fps;
  3. once with ``MEATMODELER_SYNC_STAGES=1``: per-stage seconds that bill
     device work to the stage that queued it, and the peak allocation;
  4. once under ``torch.profiler``: device busy time (the union of kernel,
     copy and memset intervals), kernel launches, and the busy share of that
     run's wall time (the profiler slows the host, so the share is a floor).

One summary line per phase goes to stdout; everything goes as JSON to
``--out`` (default ``build/profile_headline.json``), one entry per path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from meatmodeler_tpu_torch.config import (
    DEFAULT_CONFIG,
    KeyframeConfig,
    MatcherConfig,
    OrbConfig,
    PipelineConfig,
    TrackConfig,
    VolumeConfig,
)
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch.ops import clahe_cuda
from meatmodeler_tpu_torch.pipeline import process

REPO = Path(__file__).resolve().parents[2]
HEADLINE_FRAMES = 300


def headline_clip(device):
    """The headline scene (the JAX package's ``bench.py`` scene) and its clip
    rendered on ``device``."""
    scene = TurntableScene(image_size=(1920, 1080), focal=1500.0, noise_sigma=1.5)
    frames, _, corners = render_sequence(scene, HEADLINE_FRAMES, seed=0, backend="torch", device=device)
    return scene, frames, corners


def headline_config() -> PipelineConfig:
    """The headline configuration: field for field the value of the JAX
    package's ``bench.bench_config()`` (``bench.py:118-198``, where each
    knob's measurement is noted), in this package's config classes.

    Denser keyframes than the reference's 0.1 rule (the resolution-invariant
    ``threshold_abs=96``, window 15, the displacement trigger 0.015); 4096
    ORB features on 4 levels; 2048 matches per pair; 8192 tracks over at
    most 64 keyframes, n-view triangulation, a 3 px track gate; a 64^3
    carve with closing 0.015 and 0.9 view agreement; the host C++ pass 1 at
    1/6 resolution; half-resolution grey keyframes."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(KeyframeConfig(), threshold_abs=96.0, window=15, flow_threshold=0.015),
        orb=OrbConfig(num_features=4096, num_levels=4),
        matcher=MatcherConfig(max_matches=2048),
        volume=dataclasses.replace(VolumeConfig(), carve_close_frac=0.015, carve_vote_frac=0.9, voxel_resolution=64),
        tracks=TrackConfig(max_tracks=8192, max_keyframes=64, triangulation="nview", max_reproj_px=3.0),
        frame_chunk=32,
        pass1_backend="host",
        pass1_downscale=6,
        pass2_downscale=2,
        pass2_enhance="grey",
    )


def detector_config(config):
    """``config`` on the board-finding default path: the JAX package's
    default pass 1 ("device") and pass-2 enhance ("bgr_lab"), and the
    device chessboard detector."""
    return dataclasses.replace(
        config, pass1_backend="device", pass2_enhance="bgr_lab",
        chessboard=dataclasses.replace(config.chessboard, detector="device"),
    )


def _timed_process(frames, corners, config):
    t0 = time.perf_counter()
    res = process(frames, config=config, known_corners=corners, device="cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def _device_busy(trace_path: Path):
    """(busy ms, kernel launches) from a chrome trace: the union of the
    device's kernel, memcpy and memset intervals."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans, kernels = [], 0
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            kernels += cat == "kernel"
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, kernels


def profile_path(label, scene, frames, corners, config, warm_runs, report):
    """The four runs of one path; fills ``report[label]``."""
    rep = report[label] = {}
    wall, res = _timed_process(frames, corners, config)
    rep["cold"] = {"wall_s": wall, "stages": res.metrics["timings"]}
    print(f"[{label}] cold: wall {wall} s stages {json.dumps(res.metrics['timings'])}")

    walls = []
    for _ in range(warm_runs):
        wall, res = _timed_process(frames, corners, config)
        walls.append(wall)
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else [walls[0]] * 3
    rep["warm"] = {
        "wall_s": walls, "median_s": q[1], "q1_s": q[0], "q3_s": q[2],
        "fps_at_median": HEADLINE_FRAMES / q[1],
        "keyframes": res.metrics["counters"]["keyframes"], "points": len(res.points),
        "rmse_px": res.reprojection_rmse,
        "volume_err": (res.volume - scene.volume) / scene.volume,
    }
    print(f"[{label}] warm x{len(walls)}: median {q[1]} s (q1 {q[0]}, q3 {q[2]}), {HEADLINE_FRAMES / q[1]} fps; "
          f"keyframes {rep['warm']['keyframes']} points {rep['warm']['points']} "
          f"rmse {res.reprojection_rmse} volume err {rep['warm']['volume_err']}")

    torch.cuda.reset_peak_memory_stats()
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        wall, res = _timed_process(frames, corners, config)
    finally:
        del os.environ["MEATMODELER_SYNC_STAGES"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    # Pass 1's own split (decimation, upload, scan dispatch, flag sync, ...).
    pass1 = {k: v for k, v in res.metrics["counters"].items() if k.startswith("pass1_") and k.endswith("_s")}
    rep["synced"] = {"wall_s": wall, "stages": res.metrics["timings"], "pass1_split_s": pass1, "peak_alloc_mib": peak_mib}
    print(f"[{label}] synced: wall {wall} s peak alloc {peak_mib} MiB stages {json.dumps(res.metrics['timings'])} "
          f"pass1 split {json.dumps(pass1)}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            wall, _ = _timed_process(frames, corners, config)
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        busy_ms, kernels = _device_busy(trace)
    rep["profiled"] = {
        "wall_s": wall, "device_busy_ms": busy_ms, "busy_share": busy_ms / 1e3 / wall,
        "kernel_launches": kernels,
    }
    print(f"[{label}] profiled: wall {wall} s device busy {busy_ms} ms share {busy_ms / 1e3 / wall} "
          f"kernel launches {kernels}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm-runs", type=int, default=10)
    ap.add_argument("--out", default=str(REPO / "build" / "profile_headline.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_headline: CUDA is not available", file=sys.stderr)
        return 2
    config = headline_config()
    report = {"device": torch.cuda.get_device_name(0), "frames": HEADLINE_FRAMES}
    report["library_prebuilt"] = clahe_cuda.LIBRARY.exists()

    t0 = time.perf_counter()
    scene, frames, corners = headline_clip("cuda")
    torch.cuda.synchronize()
    report["render_s"] = time.perf_counter() - t0
    print(f"rendered {tuple(frames.shape)} in {report['render_s']} s (library prebuilt: {report['library_prebuilt']})")

    profile_path("known", scene, frames, corners, config, args.warm_runs, report)
    profile_path("detector", scene, frames, None, detector_config(config), args.warm_runs, report)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
