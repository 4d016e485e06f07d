"""Time the CLAHE CUDA kernels against their byte bound on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.clahe_bench [--sweep] [--ptxas] [--compare SOURCE]

For each path shape and input kind: each kernel's device time, its plain
PyTorch version's, the bytes it must move (each input read once, each
output written once), the bound those bytes set at the card's memory rate,
and the share of the bound reached. Input kinds: "scene", grey frames of
the headline scene rendered on the card (the paths' own kind of image);
"random", seeded uint8-valued pixels; "flat", one value everywhere (the
LUT kernel's worst shared-atomic contention).

Times are medians over 25 launches, each between two CUDA events with the
L2 cache flushed before it, all queued behind a device sleep so that the
host's time to launch is not in the window.

  --sweep    times the LUT kernel with every tile built by a block and
             with every tile built by a warp, over tile areas from 510 to
             8160 pixels: the measurement behind ``kWarpTileMaxArea`` in
             ``csrc/clahe.cu``;
  --ptxas    compiles ``csrc/clahe.cu`` once more with ``-Xptxas -v`` and
             prints each kernel's registers, shared memory and spills;
  --compare  builds another ``clahe.cu`` with the same C interface (an
             earlier version) and times both libraries' kernels at the same
             inputs in turns: other, this, this, other.

``chip_smoke.py`` takes its timing and bound helpers from here.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from meatmodeler_tpu_torch.ops import clahe as clahe_mod
from meatmodeler_tpu_torch.ops import clahe_cuda, color, cuda_build

# One H100 SXM's HBM3 rate (NVIDIA's data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
PATH_SHAPES = [(22, 540, 960), (32, 180, 320), (12, 180, 320)]
# Tile areas of the sweep: 1080p divided by 8, 6, 4, 3 and 2 under an 8x8
# grid, with the batch scaled to keep ~11.4 M pixels (22 half-res frames).
SWEEP_SHAPES = [(352, 135, 240), (198, 180, 320), (88, 270, 480), (50, 360, 640), (22, 540, 960)]
_FLUSH_BYTES = 128 * 2**20  # over twice the H100's 50 MB L2
_SLEEP_CYCLES = 20_000_000  # ~10 ms at the card's clock: longer than queueing 25 launches


def lut_bytes(shape, tiles=(8, 8)) -> int:
    """Image read once, LUTs written once."""
    b, h, w = shape
    return 4 * (b * h * w + b * tiles[0] * tiles[1] * 256)


def apply_bytes(shape, tiles=(8, 8)) -> int:
    """Image and LUTs read once, output written once."""
    b, h, w = shape
    return 4 * (2 * b * h * w + b * tiles[0] * tiles[1] * 256)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_ms(fn: Callable[[], object], reps: int = 25) -> float:
    """Median device time of one fn() (ms), by CUDA events around each
    launch, with a cold L2 and the host's launch time hidden."""
    for _ in range(3):
        fn()
    flush = torch.zeros(_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(_SLEEP_CYCLES)
    for start, end in zip(starts, ends):
        # A read, not a write: written lines would stay dirty in L2 and the
        # timed kernel would pay for their write-back.
        flush.max()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_kernels(img: torch.Tensor, tiles=(8, 8)) -> Dict[str, Dict[str, float]]:
    """Per kernel at ``img`` through the wrappers: ms, plain_ms, bytes,
    bound_ms, share."""
    lut = clahe_mod.lut_reference(img, 3.5, tiles)
    shape = tuple(img.shape)
    rows = {
        "clahe_lut": (
            lambda: clahe_cuda.clahe_lut(img, 3.5, tiles),
            lambda: clahe_mod.lut_reference(img, 3.5, tiles),
            lut_bytes(shape, tiles),
        ),
        "clahe_apply": (
            lambda: clahe_cuda.clahe_apply(img, lut, tiles),
            lambda: clahe_mod.apply_reference(img, lut, tiles),
            apply_bytes(shape, tiles),
        ),
    }
    out = {}
    for name, (kernel, plain, nbytes) in rows.items():
        ms, bound = time_ms(kernel), bound_ms(nbytes)
        out[name] = {"ms": ms, "plain_ms": time_ms(plain), "bytes": nbytes, "bound_ms": bound, "share": bound / ms}
    return out


def scene_greys(device, frames: int = 32) -> torch.Tensor:
    """(frames, 1080, 1920) float32 BT.601 grey of the headline scene,
    rendered on ``device``."""
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence

    scene = TurntableScene(image_size=(1920, 1080), focal=1500.0, noise_sigma=1.5)
    bgr, _, _ = render_sequence(scene, frames, seed=0, backend="torch", device=device)
    return color.bgr_to_grey(torch.from_numpy(bgr).to(device)).to(torch.float32)


def input_image(kind: str, shape, device, scene=None) -> torch.Tensor:
    """A (B, H, W) float32 input of one kind; "scene" decimates ``scene``
    (full-resolution greys) to H x W by striding."""
    if kind == "flat":
        return torch.full(shape, 135.0, device=device)
    if kind == "random":
        rng = np.random.default_rng(1)
        return torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.float32)).to(device)
    b, h, w = shape
    step = scene.shape[1] // h
    return torch.round(scene[:b, ::step, ::step][:, :h, :w]).contiguous()


def print_row(label: str, rows: Dict[str, Dict[str, float]]) -> None:
    for name, r in rows.items():
        print(f"{label} {name}: {r['ms'] * 1e3:.3f} us (plain {r['plain_ms'] * 1e3:.3f} us), "
              f"{r['bytes']} B, bound {r['bound_ms'] * 1e3:.3f} us, share {r['share']:.3f}")


def sweep(device) -> None:
    """The LUT kernel with all tiles by blocks, then all by warps, through
    the library's ``clahe_lut_with_crossover`` entry."""
    lib = clahe_cuda.build()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clahe_lut_with_crossover.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p]
    for shape in SWEEP_SHAPES:
        b, h, w = shape
        th, tw = clahe_mod.tile_geometry(h, w, (8, 8))
        clip = max(1, int(3.5 * th * tw / 256.0))
        for kind in ("random", "flat"):
            img = input_image(kind, shape, device)
            lut = torch.empty((b, 64, 256), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream().cuda_stream

            def run(area):
                args = (img.data_ptr(), lut.data_ptr(), b, h, w, 8, 8, th, tw, clip, area, stream)
                if lib.clahe_lut_with_crossover(*args):
                    raise RuntimeError("clahe_lut launch failed")

            ms = {mode: time_ms(lambda: run(area)) for mode, area in (("block", 0), ("warp", 1 << 30))}
            print(f"sweep {shape} tile {th}x{tw}={th * tw} px {kind}: block {ms['block'] * 1e3:.3f} us, "
                  f"warp {ms['warp'] * 1e3:.3f} us, bound {bound_ms(lut_bytes(shape)) * 1e3:.3f} us")


def ptxas() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        print(cuda_build.compile_source(clahe_cuda.SOURCE, Path(tmp) / "lib.so", ("-Xptxas", "-v")))


def _raw_kernels(lib, img: torch.Tensor, tiles=(8, 8)):
    """(lut launch, apply launch) of ``lib``'s C entries at ``img``, outputs
    allocated once."""
    b, h, w = img.shape
    ty, tx = tiles
    th, tw = clahe_mod.tile_geometry(h, w, tiles)
    clip = max(1, int(3.5 * th * tw / 256.0))
    lut_in = clahe_mod.lut_reference(img, 3.5, tiles)
    lut = torch.empty_like(lut_in)
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream().cuda_stream

    def run_lut():
        if lib.clahe_lut(img.data_ptr(), lut.data_ptr(), b, h, w, ty, tx, th, tw, clip, stream):
            raise RuntimeError("clahe_lut launch failed")

    def run_apply():
        if lib.clahe_apply(img.data_ptr(), lut_in.data_ptr(), out.data_ptr(), b, h, w, ty, tx, th, tw, stream):
            raise RuntimeError("clahe_apply launch failed")

    return run_lut, run_apply


def compare(source: Path, device, scene) -> None:
    """Both libraries' kernels at the path shapes, in turns other, this,
    this, other; each line gives the two means."""
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.compile_source(source, Path(tmp) / "other.so")
        other = ctypes.CDLL(str(Path(tmp) / "other.so"))
        this = clahe_cuda.build()
        p, i = ctypes.c_void_p, ctypes.c_int
        other.clahe_lut.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
        other.clahe_apply.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        for shape in PATH_SHAPES:
            for kind in ("scene", "random", "flat"):
                img = input_image(kind, shape, device, scene)
                kernels = {"other": _raw_kernels(other, img), "this": _raw_kernels(this, img)}
                for k, name in enumerate(("clahe_lut", "clahe_apply")):
                    times = {"other": [], "this": []}
                    for which in ("other", "this", "this", "other"):
                        times[which].append(time_ms(kernels[which][k]))
                    o, t = statistics.mean(times["other"]), statistics.mean(times["this"])
                    print(f"compare {shape} {kind} {name}: other {o * 1e3:.3f} us, this {t * 1e3:.3f} us, "
                          f"bound {bound_ms((lut_bytes if k == 0 else apply_bytes)(shape)) * 1e3:.3f} us")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--compare", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("clahe_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.ptxas:
        ptxas()
    clahe_cuda.build()
    scene = scene_greys(dev)
    for shape in PATH_SHAPES:
        for kind in ("scene", "random", "flat"):
            print_row(f"{kind} {shape}", time_kernels(input_image(kind, shape, dev, scene)))
    if args.sweep:
        sweep(dev)
    if args.compare is not None:
        compare(args.compare, dev, scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
