"""Wall times, host syncs and kernel launches of the three paths that run
``estimate_relative_pose``, on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.relpose_paths [--runs 5] [--label NAME] [--out FILE]

It calls the package's public entry points only (``chain_poses``,
``process`` with ``markerless_config()``, ``reconstruct_two_view``,
``ransac.estimate_relative_pose``) and ``tools/profile_headline``'s clip and
configs, so the same file runs against an earlier tree of the package:
copy it into that tree's ``meatmodeler_tpu_torch/tools/`` and run it from
that tree's root. To compare two trees on one card, run parent, change,
change, parent in one call.

On the board-free clip (``markerless_clip``: 120 grey 1280x720 frames):
  odometry     ``chain_poses`` over the clip: warm wall seconds (a device
               sync at the end; median of ``--runs``) and seconds per frame;
               the first 20 steps once more with the sync debug mode on:
               its synchronizing CUDA operations, each attributed to the
               Python line that made it, split into ``torch.linalg`` calls
               and the rest; and the seconds those 20 steps spend inside
               ``estimate_relative_pose`` (each call synced before and
               after);
  estimate     one warm ``estimate_relative_pose`` at the odometry's first
               step's arguments: its synchronizing operations, the kernel
               launch calls and device activities the profiler sees, and its
               synced wall (median of 20 calls);
  markerless   ``process`` with ``markerless_config()``: warm wall (median)
               and the ``pose_chain`` stage's seconds with the stages synced
               (``MEATMODELER_SYNC_STAGES=1``, one more run);
  two_view     ``reconstruct_two_view`` on frames 0 and 4: warm wall
               (median).
Each number is printed with the card's name and power limit, and the whole
record goes to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import linecache
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from meatmodeler_tpu_torch.geometry import ransac
from meatmodeler_tpu_torch.odometry import chain_poses
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.tools.profile_headline import markerless_clip, markerless_config
from meatmodeler_tpu_torch.two_view import reconstruct_two_view

SYNC_STEPS = 20


def _wall(run: Callable[[], object]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _median_wall(run: Callable[[], object], runs: int) -> Dict[str, object]:
    """One warm-up run, then ``runs`` timed ones."""
    run()
    walls = [_wall(run) for _ in range(runs)]
    return {"median_s": statistics.median(walls), "walls_s": walls}


@contextlib.contextmanager
def _first_call(module, name):
    """Records the first call of ``module.name`` as (args, kwargs)."""
    first, real = [], getattr(module, name)

    def call(*args, **kwargs):
        if not first:
            first.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield first
    finally:
        setattr(module, name, real)


def sync_sites(run: Callable[[], object]) -> Dict[str, object]:
    """``run()`` with torch's sync debug mode on (which misses some): its
    synchronizing operations by the Python line that made them, and how
    many of those lines call ``torch.linalg``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)
    )
    files = {f"{Path(w.filename).name}:{w.lineno}": (w.filename, w.lineno) for w in caught}
    linalg = sum(n for site, n in sites.items() if "torch.linalg" in linecache.getline(*files[site]))
    return {"syncs": sum(sites.values()), "linalg_syncs": linalg, "by_line": dict(sites.most_common(12))}


def estimate_seconds(run: Callable[[], object]) -> float:
    """Seconds ``run()`` spends inside ``ransac.estimate_relative_pose``,
    each call synced before and after."""
    total, real = [0.0], ransac.estimate_relative_pose

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            total[0] += time.perf_counter() - t0

    ransac.estimate_relative_pose = call
    try:
        run()
    finally:
        ransac.estimate_relative_pose = real
    return total[0]


def estimate_at(call) -> Dict[str, object]:
    """One warm ``estimate_relative_pose`` at a recorded call: syncs,
    launches and device activities (profiler), synced wall (median of 20)."""
    args, kwargs = call

    def run():
        return ransac.estimate_relative_pose(
            *args, **dict(kwargs, generator=torch.Generator(device="cuda").manual_seed(0))
        )

    run()
    syncs = sync_sites(run)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    device = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    walls = [_wall(run) for _ in range(20)]
    return {**syncs, "launch_calls": launches, "device_activities": device, "median_s": statistics.median(walls)}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("relpose_paths: CUDA is not available", file=sys.stderr)
        return 2
    gpu = gpu_line()
    rep: Dict[str, object] = {"label": args.label, "gpu": gpu, "tree": str(Path(__file__).resolve().parents[2])}
    scene, frames, _ = markerless_clip("cuda")
    k = scene.intrinsics

    with _first_call(ransac, "estimate_relative_pose") as first:
        rep["odometry"] = _median_wall(lambda: chain_poses(frames, k, device="cuda"), args.runs)
    rep["odometry"]["s_per_frame"] = rep["odometry"]["median_s"] / len(frames)
    steps = frames[: SYNC_STEPS + 1]
    rep["odometry"]["sync_steps"] = SYNC_STEPS
    rep["odometry"]["syncs"] = sync_sites(lambda: chain_poses(steps, k, device="cuda"))
    rep["odometry"]["estimate_s_in_steps"] = estimate_seconds(lambda: chain_poses(steps, k, device="cuda"))
    rep["odometry"]["steps_wall_s"] = _wall(lambda: chain_poses(steps, k, device="cuda"))
    rep["estimate"] = estimate_at(first[0])

    config = markerless_config()
    rep["markerless"] = _median_wall(lambda: process(frames, config=config, device="cuda"), args.runs)
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        res = process(frames, config=config, device="cuda")
    finally:
        del os.environ["MEATMODELER_SYNC_STAGES"]
    rep["markerless"]["pose_chain_synced_s"] = res.metrics["timings"]["pose_chain"]
    rep["markerless"]["points"] = int(len(res.points))

    rep["two_view"] = _median_wall(lambda: reconstruct_two_view(frames[0], frames[4], k, device="cuda"), args.runs)
    print(f"[{args.label}] {gpu}: {json.dumps(rep)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
