"""The host keyframe scan: the serial ``native/pass1.cpp`` against the port's
threaded copy (``meatmodeler_tpu_torch/native/pass1.cpp``), on the host CPU.

    python3 -m meatmodeler_tpu_torch.tools.host_pass1_bench [--repeats 5] [--width 1920]

Renders the board cells' scene (``TurntableScene(1920x1080, focal 1500,
noise 1.5)``, on the card where there is one) and decimates it to 320x180
greys, then scans it at both board cells' operating points:

- ``known``: 300 frames in chunks of 32, bootstrapped at frame 0, as
  ``pipeline._run_pass1_host`` scans a ``board_known_1080p`` clip;
- ``batch``: one 60-frame call from frame 0 (a 60-frame clip of the scene),
  as ``parallel.batch._batch_prepass`` scans a ``board_batch8_1080p`` video.

For the serial scan and for the port's at 1, 2, 4 and all allowed threads
(``os.sched_getaffinity``) it prints, in turns over ``--repeats`` rounds, the
median and least seconds a clip and the port's median seconds in each phase
(CLAHE, pyramids, LK, Shi-Tomasi: walls on the calling thread), with the
host's CPU model and allowed cores. Every run's flags and carried state are
held to the serial scan's; exit 1 where any differs. ``--width`` renders a
smaller clip of the same scene, decimated to the same 320x180 (a rehearsal
on a CPU). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import statistics
import time

import numpy as np

from meatmodeler_tpu_torch.io import native_ops, native_pass1
from meatmodeler_tpu_torch.io._native_build import BUILD_DIR, NATIVE_DIR, NativeLib
from meatmodeler_tpu_torch.tools.profile_headline import headline_config

PHASES = ("clahe", "pyramids", "lk", "shi_tomasi")
POINTS = {"known": (300, 32), "batch": (60, 60)}  # frames, chunk


def _configure_serial(lib, ct):
    lib.pass1_scan.argtypes = native_pass1._scan_argtypes(ct)
    lib.pass1_scan.restype = None


class _SerialLib:
    """``native/pass1.cpp`` behind the port's call: drops the thread count and
    answers 1."""

    def __init__(self, lib):
        self._lib = lib

    def pass1_scan(self, *args):
        self._lib.pass1_scan(*args[:-1])
        return 1


_serial = NativeLib(
    src=NATIVE_DIR / "pass1.cpp", lib_path=BUILD_DIR / "_libpass1.so", configure=_configure_serial
)


def clip(frames: int, width: int) -> np.ndarray:
    """(frames, 180, 320) uint8 greys of the board cells' scene rendered at
    ``width`` x ``width * 9 / 16`` (the focal scaled with it)."""
    import torch

    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence

    scene = TurntableScene(image_size=(width, width * 9 // 16), focal=1500.0 * width / 1920, noise_sigma=1.5)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    bgr, _, _ = render_sequence(scene, frames, seed=1, backend="torch", device=device)
    return native_ops.bgr_to_grey_down(bgr, width // 320)


def scan(greys: np.ndarray, chunk: int, threads: int | None, config=None):
    """Scan ``greys`` in chunks from a bootstrap at 0: (seconds, flags, final
    carried state); ``threads`` None runs ``native/pass1.cpp``."""
    config = config or headline_config()
    h, w = greys.shape[1:]
    scanner = native_pass1.HostPass1Scanner(config, h, w, full_width=w * 6, _threads=threads or 1)
    if threads is None:
        scanner._lib = _SerialLib(_serial.load())
    flags = []
    t0 = time.perf_counter()
    for i in range(0, len(greys), chunk):
        flags.append(scanner.scan(greys[i : i + chunk], bootstrap_at=0 if i == 0 else -1)[0])
    seconds = time.perf_counter() - t0
    state = [scanner._prev, scanner._pts, scanner._mask, scanner._acc, scanner._acc_flow]
    return seconds, np.concatenate(flags), state


def phase_seconds() -> list:
    """The port's seconds in each phase since the last read."""
    out = (ctypes.c_double * 4)()
    native_pass1._native.load().pass1_phase_seconds(out)
    return list(out)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920, help="render width (a multiple of 320)")
    args = ap.parse_args(argv)
    if native_pass1._native.load() is None or _serial.load() is None:
        raise SystemExit("the native scans do not build: no C++ toolchain")
    allowed = len(os.sched_getaffinity(0))
    counts = sorted({1, 2, 4, allowed})
    print(f"host: {_cpu_model()}, {allowed} cores allowed, {os.cpu_count()} online")
    report = {"cpu": _cpu_model(), "cores_allowed": allowed, "points": {}}
    ok = True
    for point, (frames, chunk) in POINTS.items():
        greys = clip(frames, args.width)
        runs = {"serial": []} | {t: [] for t in counts}
        phases = {t: [] for t in counts}
        _, ref_flags, ref_state = scan(greys, chunk, None)
        for _ in range(args.repeats):
            for name in runs:
                threads = None if name == "serial" else name
                phase_seconds()
                seconds, flags, state = scan(greys, chunk, threads)
                if threads is not None:
                    phases[threads].append(phase_seconds())
                same = np.array_equal(flags, ref_flags) and all(np.array_equal(a, b) for a, b in zip(state, ref_state))
                ok &= same
                runs[name].append(seconds)
        print(f"{point}: {frames} frames of {greys.shape[1]}x{greys.shape[2]} in chunks of {chunk}, "
              f"{int(ref_flags.sum())} keyframes after the bootstrap")
        rows = {}
        for name, secs in runs.items():
            row = {"median_s": statistics.median(secs), "min_s": min(secs)}
            if name != "serial":
                row |= {p: statistics.median(x[i] for x in phases[name]) for i, p in enumerate(PHASES)}
            rows["serial" if name == "serial" else f"threads_{name}"] = row
            print(f"  {name:>6}: median {row['median_s']:.4f} s, least {row['min_s']:.4f} s"
                  + ("".join(f", {p} {row[p]:.4f}" for p in PHASES) if name != "serial" else ""))
        report["points"][point] = rows
    report["same_as_serial"] = bool(ok)
    print("flags and carried state equal to the serial scan's:", ok)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
