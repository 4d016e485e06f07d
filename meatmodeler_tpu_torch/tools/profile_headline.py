"""Time and profile the port's headline run on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.profile_headline [--warm-runs 10] [--out FILE]

Run from the repo root (it imports ``bench.bench_config``). It renders the
headline clip on the card (300 frames, 1920x1080, seed 0, with its
ground-truth board corners) and runs ``process`` on it four ways:

  1. cold: the first ``process`` of the process (the CLAHE library is built
     first if it is missing);
  2. warm, ``--warm-runs`` times: e2e seconds (median and quartiles) and fps;
  3. once with ``MEATMODELER_SYNC_STAGES=1``: per-stage seconds that bill
     device work to the stage that queued it, and the peak allocation;
  4. once under ``torch.profiler``: device busy time (the union of kernel,
     copy and memset intervals), kernel launches, and the busy share of that
     run's wall time (the profiler slows the host, so the share is a floor).

One summary line per phase goes to stdout; everything goes as JSON to
``--out`` (default ``build/profile_headline.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch.ops import clahe_cuda
from meatmodeler_tpu_torch.pipeline import process

REPO = Path(__file__).resolve().parents[2]
HEADLINE_FRAMES = 300


def headline_clip(device):
    """The headline scene (``bench.py``'s) and its clip rendered on ``device``."""
    scene = TurntableScene(image_size=(1920, 1080), focal=1500.0, noise_sigma=1.5)
    frames, _, corners = render_sequence(scene, HEADLINE_FRAMES, seed=0, backend="torch", device=device)
    return scene, frames, corners


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm-runs", type=int, default=10)
    ap.add_argument("--out", default=str(REPO / "build" / "profile_headline.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_headline: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import bench

    config = bench.bench_config()
    report = {"device": torch.cuda.get_device_name(0), "frames": HEADLINE_FRAMES}
    report["library_prebuilt"] = clahe_cuda.LIBRARY.exists()

    t0 = time.perf_counter()
    scene, frames, corners = headline_clip("cuda")
    torch.cuda.synchronize()
    report["render_s"] = time.perf_counter() - t0
    print(f"rendered {tuple(frames.shape)} in {report['render_s']} s")

    wall, res = _timed_process(frames, corners, config)
    report["cold"] = {"wall_s": wall, "stages": res.metrics["timings"]}
    print(f"cold: wall {wall} s (library prebuilt: {report['library_prebuilt']}) stages {json.dumps(res.metrics['timings'])}")

    walls = []
    for _ in range(args.warm_runs):
        wall, res = _timed_process(frames, corners, config)
        walls.append(wall)
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else [walls[0]] * 3
    report["warm"] = {
        "wall_s": walls, "median_s": q[1], "q1_s": q[0], "q3_s": q[2],
        "fps_at_median": HEADLINE_FRAMES / q[1],
        "keyframes": res.metrics["counters"]["keyframes"], "points": len(res.points),
        "rmse_px": res.reprojection_rmse,
        "volume_err": (res.volume - scene.volume) / scene.volume,
    }
    print(f"warm x{len(walls)}: median {q[1]} s (q1 {q[0]}, q3 {q[2]}), {HEADLINE_FRAMES / q[1]} fps; "
          f"keyframes {report['warm']['keyframes']} points {report['warm']['points']} "
          f"rmse {res.reprojection_rmse} volume err {report['warm']['volume_err']}")

    torch.cuda.reset_peak_memory_stats()
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        wall, res = _timed_process(frames, corners, config)
    finally:
        del os.environ["MEATMODELER_SYNC_STAGES"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    report["synced"] = {"wall_s": wall, "stages": res.metrics["timings"], "peak_alloc_mib": peak_mib}
    print(f"synced: wall {wall} s peak alloc {peak_mib} MiB stages {json.dumps(res.metrics['timings'])}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            wall, _ = _timed_process(frames, corners, config)
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        busy_ms, kernels = _device_busy(trace)
    report["profiled"] = {
        "wall_s": wall, "device_busy_ms": busy_ms, "busy_share": busy_ms / 1e3 / wall,
        "kernel_launches": kernels,
    }
    print(f"profiled: wall {wall} s device busy {busy_ms} ms share {busy_ms / 1e3 / wall} "
          f"kernel launches {kernels}")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
