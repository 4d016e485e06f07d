"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CLAHE kernels from ``meatmodeler_tpu_torch/csrc`` (nvcc),
     removing any library left from an earlier build first;
  3. hold each kernel against its plain PyTorch version on the card
     (max |diff| <= 1e-3) and time both (CUDA events, median of 25 warm
     runs at (4, 540, 960); the JSON record carries these times);
  4. render the headline clip (300 frames, 1080p) on the card and run
     ``process`` with ``bench.bench_config()`` and the renderer's board
     corners twice, with the launch counts reset just before; check the
     repo's accuracy bounds and that every kernel ran on this path; then
     compare the kernels once more at the path's own CLAHE shape (all
     keyframes, grey at 540x960);
  5. the board-finding default path: the same clip through ``process`` with
     ``detector_config(bench.bench_config())`` (device pass 1, ``bgr_lab``
     enhance, device chessboard detector) and NO known corners, twice, with
     the launch counts reset just before; the same checks; then compare
     the kernels at this path's two CLAHE inputs: the first pass-1 chunk
     (32, 180, 320) and the keyframes' LAB lightness (n_kf, 540, 960),
     and time both there too.
The last two lines are a JSON record of the kernels (launches summed over
both paths) and the device line.
Per-stage attribution, device busy share and the e2e spread come from
``python3 -m meatmodeler_tpu_torch.tools.profile_headline``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from meatmodeler_tpu.io import native_ops
from meatmodeler_tpu_torch.ops import clahe as clahe_mod
from meatmodeler_tpu_torch.ops import clahe_cuda, color
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.tools.profile_headline import HEADLINE_FRAMES, detector_config, headline_clip

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
TOL = 1e-3
# The repo's own accuracy bounds for the headline clip (BENCH_r05.json,
# robustness.bounds).
RMSE_MAX_PX = 1.094
VOLUME_ERR_MAX = 0.35
KERNELS = {
    "clahe_lut": ("meatmodeler_tpu/ops/clahe_pallas.py:192", "_lut_kernel"),
    "clahe_apply": ("meatmodeler_tpu/ops/clahe_pallas.py:208", "_apply_kernel"),
}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 25) -> float:
    """Median warm time of fn() on the current stream, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_kernels(dev, cases, err):
    """Each kernel against its plain version; raises on disagreement, folds
    the max errors into ``err``. A case is (shape, tiles) for seeded
    uint8-valued input, or (label, float32 image stack on the card)."""
    rng = np.random.default_rng(0)
    for case, arg in cases:
        if isinstance(case, str):
            img, tiles, label = arg, (8, 8), f"{case} {tuple(arg.shape)}"
        else:
            img = torch.from_numpy(rng.integers(0, 256, size=case).astype(np.float32)).to(dev)
            tiles, label = arg, f"{case} tiles={arg}"
        lut_k = clahe_cuda.clahe_lut(img, 3.5, tiles)
        lut_p = clahe_mod.lut_reference(img, 3.5, tiles)
        out_k = clahe_cuda.clahe_apply(img, lut_p, tiles)
        out_p = clahe_mod.apply_reference(img, lut_p, tiles)
        whole = (clahe_mod.clahe(img, tiles=tiles) - clahe_mod.clahe_reference(img, tiles=tiles)).abs().max()
        torch.cuda.synchronize()
        e_lut = float((lut_k - lut_p).abs().max())
        e_app = max(float((out_k - out_p).abs().max()), float(whole))
        print(f"kernel check {label}: lut max|d|={e_lut:.3g} apply max|d|={e_app:.3g}")
        if not (e_lut <= TOL and e_app <= TOL):
            raise AssertionError(f"CLAHE kernel disagrees with its plain version at {label}")
        err["clahe_lut"] = max(err["clahe_lut"], e_lut)
        err["clahe_apply"] = max(err["clahe_apply"], e_app)


def time_kernels(dev, img=None):
    """Warm median times of each kernel and its plain version on ``img``
    (default: seeded uint8-valued (4, 540, 960))."""
    if img is None:
        rng = np.random.default_rng(1)
        img = torch.from_numpy(rng.integers(0, 256, size=(4, 540, 960)).astype(np.float32)).to(dev)
    lut = clahe_mod.lut_reference(img)
    ms = {
        "clahe_lut": _time_ms(lambda: clahe_cuda.clahe_lut(img, 3.5, (8, 8))),
        "clahe_apply": _time_ms(lambda: clahe_cuda.clahe_apply(img, lut, (8, 8))),
    }
    plain_ms = {
        "clahe_lut": _time_ms(lambda: clahe_mod.lut_reference(img)),
        "clahe_apply": _time_ms(lambda: clahe_mod.apply_reference(img, lut)),
    }
    whole_k = _time_ms(lambda: clahe_mod.clahe(img))
    whole_p = _time_ms(lambda: clahe_mod.clahe_reference(img))
    print(f"CLAHE {tuple(img.shape)} warm median ms: kernels {ms} plain {plain_ms}; "
          f"whole clahe kernels {whole_k:.4f} plain {whole_p:.4f}")
    return ms, plain_ms


def run_path(label, scene, frames, corners, config):
    """One path through ``process`` on the headline clip, twice, with the
    launch counts reset just before and read just after. Returns (launches,
    counters of the last run)."""
    clahe_cuda.reset_launches()
    for run in range(2):
        t0 = time.perf_counter()
        res = process(frames, path=str(OUT / f"{label}{run}"), config=config, known_corners=corners, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = res.metrics["counters"]
        vol_err = (res.volume - scene.volume) / scene.volume
        low = res.volume_confidence["low_confidence"]
        print(f"[{label}] run {run}: wall {wall:.3f} s ({HEADLINE_FRAMES / wall:.2f} fps)")
        print("  stages:", json.dumps({k: round(v, 4) for k, v in res.metrics["timings"].items()}))
        print(f"  keyframes {c['keyframes']} of {c['keyframes_selected']} selected, points {len(res.points)} "
              f"rmse {res.reprojection_rmse:.4f} volume {res.volume:.4f} carved {res.volume_carved:.4f} "
              f"truth {scene.volume:.4f} err {vol_err:+.4f} confidence {json.dumps(res.volume_confidence)}")
        print(f"  keyframe indices {c['keyframe_indices']}")
        print(f"  clahe_cuda.LAUNCHES {clahe_cuda.LAUNCHES}")
        if c["keyframes"] < 3 or len(res.points) < 500:
            raise AssertionError("too few keyframes or points")
        if not (np.isfinite(res.reprojection_rmse) and res.reprojection_rmse <= RMSE_MAX_PX):
            raise AssertionError(f"rmse {res.reprojection_rmse} outside {RMSE_MAX_PX}")
        if not np.isfinite(res.points).all() or res.points.shape[1] != 3:
            raise AssertionError("non-finite or misshapen cloud")
        if not low and not abs(vol_err) <= VOLUME_ERR_MAX:
            raise AssertionError(f"hull volume error {vol_err} outside {VOLUME_ERR_MAX}")
    launches = dict(clahe_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    return launches, c


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = _gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")

    clahe_cuda.LIBRARY.unlink(missing_ok=True)
    t0 = time.perf_counter()
    clahe_cuda.build()
    print(f"built {clahe_cuda.LIBRARY} in {time.perf_counter() - t0:.2f} s")

    err = {"clahe_lut": 0.0, "clahe_apply": 0.0}
    compare_kernels(dev, [((4, 540, 960), (8, 8)), ((2, 67, 120), (8, 8)), ((1, 64, 80), (4, 4))], err)
    ms, plain_ms = time_kernels(dev)

    import bench

    t0 = time.perf_counter()
    scene, frames, corners = headline_clip(dev)
    torch.cuda.synchronize()
    print(f"rendered {frames.shape} in {time.perf_counter() - t0:.2f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    config = bench.bench_config()

    # Phase 4: known corners, host pass 1, grey enhance.
    launches, c = run_path("known", scene, frames, corners, config)
    # Its CLAHE input: every keyframe, grey at half resolution.
    compare_kernels(dev, [((c["keyframes"], 1080 // config.pass2_downscale, 1920 // config.pass2_downscale), (8, 8))], err)

    # Phase 5: the board-finding default path, video alone.
    dconfig = detector_config(config)
    launches_d, c = run_path("detector", scene, frames, None, dconfig)
    for k in launches:
        launches[k] += launches_d[k]
    # Its two CLAHE inputs, rebuilt from the clip as the path builds them.
    p1s, p2s = dconfig.pass1_downscale, dconfig.pass2_downscale
    chunk = torch.from_numpy(native_ops.bgr_to_grey_down(frames[: dconfig.frame_chunk], p1s)).to(dev).float()
    keyframes = np.ascontiguousarray(frames[c["keyframe_indices"]][:, ::p2s, ::p2s])
    lab_l = color.bgr_to_lab(torch.from_numpy(keyframes).to(dev))[..., 0].contiguous()
    compare_kernels(dev, [("pass-1 chunk", chunk), ("pass-2 LAB L", lab_l)], err)
    time_kernels(dev, chunk)
    time_kernels(dev, lab_l)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    record = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "meatmodeler_tpu_torch/csrc/clahe.cu",
                "replaces": KERNELS[name][0],
                "launches": launches[name],
                "max_abs_err": err[name],
                "ms": ms[name],
                "plain_ms": plain_ms[name],
            }
            for name in KERNELS
        ]
    }
    print(f"gpu: {gpu}")
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
