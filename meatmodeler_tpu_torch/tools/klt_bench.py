"""Time the Lucas-Kanade CUDA kernel against its bound on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.klt_bench [--ptxas] [--compare SOURCE [--paths]]

At the three callers' settings on seeded blob textures (the keyframe scan,
(180, 320), and the odometry, (720, 1280): 128 points, 4 levels, win 21,
10 iterations; two_view, (540, 960): 96 points, 1 level, win 15, 30
iterations, seeded at the match offset): the kernel's device time, its
plain PyTorch version's, the work the call needed, the bound it sets and
the share of it reached. Times are ``clahe_bench.time_ms``'s: medians over
25 calls with a cold L2 and the host's launch time hidden.

The work is counted from this call's data: the kernel reports the
iterations each point ran at each level and the displacement each of them
sampled at (``lk_track(iterations=..., path=...)``), and a point's final
window error is counted only where its status holds. Operations: 11 per
bilinear sample (8 products, 3 sums), 10 per template pixel (gradients 4,
G 6), 16 per window pixel an iteration (sample 11, difference 1, b 4), 25
per pixel of the final error (two samples and the absolute difference
summed). Bytes: the pixels the windows read, each once: at each level of
the previous frame the union of the points' (win+3)^2 template grids, of
the current frame the union of the (win+1)^2 windows every iteration
sampled, and at level 0 the two error windows of each tracked point, all
clamped into the level as the kernel reads them; then the points, mask and
offsets read once and the outputs written once. The bound is the larger of
operations at 67 TFLOP/s (float32 outside the tensor cores) and bytes at
3.35 TB/s. The kernel's time is a chain of dependent steps of the point's
block per level (the template's staging, the G reduction, then one
gather-reduce-solve step per iteration, one block barrier each); ``steps``
(``lk_work``) gives that chain's length for the slowest point at each
level, coarsest first.

  --ptxas    compiles ``csrc/klt.cu`` once more with ``-Xptxas -v`` and
             prints the kernel's registers, shared memory and spills.
  --compare  builds another ``klt.cu`` with the same C interface (an
             earlier design) and times both libraries' kernels at the same
             inputs in turns: other, this, this, other; with ``--paths``
             also at the first calls the video-alone scan, the odometry and
             two-view make (``tools/path_calls.py``).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from meatmodeler_tpu_torch.ops import cuda_build, features, klt, klt_cuda
from meatmodeler_tpu_torch.testing import blob_texture, lk_edge_points
from meatmodeler_tpu_torch.tools.clahe_bench import HBM_BYTES_PER_S, time_ms

FP32_FLOPS_PER_S = 67e12  # one H100 SXM, float32 outside the tensor cores
SCAN = dict(win=21, levels=4, max_iters=10, eps=0.01)
TWO_VIEW = dict(win=15, levels=1, max_iters=30, eps=0.01)
DEEP = dict(win=klt_cuda.MAX_WIN, levels=klt_cuda.MAX_LEVELS, max_iters=10, eps=0.01)
# (label, image shape, settings, points, true shift)
CALLERS = [
    ("scan", (180, 320), SCAN, 128, (3.4, -2.2)),
    ("odometry", (720, 1280), SCAN, 128, (7.3, 2.6)),
    ("two_view", (540, 960), TWO_VIEW, 96, (6.3, 4.6)),
]


def seeded_case(shape, settings, n_points, shift, device):
    """(prev pyramid, curr pyramid, points, mask, initial flow or None) on
    seeded blob textures; two_view's offsets are the shift to within a
    pixel, as ORB matches give it."""
    h, w = shape
    blobs = max(60, h * w // 1000)
    a = torch.from_numpy(blob_texture(h, w, blobs=blobs)).to(device)
    b = torch.from_numpy(blob_texture(h, w, *shift, blobs=blobs)).to(device)
    pts = features.good_features(a, max_corners=n_points).xy
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random(len(pts)) > 0.1).to(device)
    flow = None
    if settings is TWO_VIEW:
        flow = torch.from_numpy((np.array(shift) + rng.uniform(-0.8, 0.8, (len(pts), 2))).astype(np.float32)).to(device)
    lv = settings["levels"]
    return klt.build_pyramid(a, lv), klt.build_pyramid(b, lv), pts, mask, flow


def lk_case(case: str, device):
    """(prev pyramid, curr pyramid, points, mask, initial flow or None,
    settings) of a named case: a caller of ``CALLERS`` on its seeded
    textures, or an edge case of the scan's settings (``flat``: one value
    everywhere, so every G is singular; ``masked``: half the points
    masked; ``ragged``: 129 points, one past a multiple of every block
    size a design might pick)
    or of a caller's (``<caller>_edges``: the 19 points of
    ``testing.lk_edge_points`` before 16 of its own, one NaN offset where
    it takes offsets), or ``deep_edges``: the odometry's frames and the
    edge points at the largest window and depth the kernel takes (win 31,
    8 levels)."""
    base = case[: -len("_edges")] if case.endswith("_edges") else case
    base = "odometry" if base == "deep" else base
    _, shape, s, n, shift = next((c for c in CALLERS if c[0] == base), CALLERS[0])
    if case == "deep_edges":
        s = dict(DEEP)
    prev, curr, pts, mask, flow = seeded_case(shape, s, 129 if case == "ragged" else n, shift, device)
    if case == "flat":
        prev, curr = [torch.full_like(p, 135.0) for p in prev], [torch.full_like(p, 135.0) for p in curr]
    if case == "masked":
        mask = torch.from_numpy(np.random.default_rng(6).random(len(pts)) > 0.5).to(device)
    if case.endswith("_edges"):
        edges = torch.from_numpy(lk_edge_points(*shape)).to(device)
        pts = torch.cat([edges, pts[:16]])
        mask = torch.cat([torch.ones(len(edges), dtype=torch.bool, device=device), mask[:16]])
        if flow is not None:
            flow = torch.cat([flow[:1].expand(len(edges), 2), flow[:16]]).clone()
            flow[3] = float("nan")
    return prev, curr, pts, mask, flow, s


def lk_kernel(prev, curr, pts, mask, flow, settings):
    """One launch of the kernel through its wrapper, reporting what each
    point ran: (FlowResult, iterations (N, levels), path (N, levels,
    max_iters, 2))."""
    levels, m = min(settings["levels"], len(prev)), settings["max_iters"]
    iterations = torch.zeros((len(pts), levels), dtype=torch.int32, device=pts.device)
    path = torch.zeros((len(pts), levels, m, 2), dtype=torch.float32, device=pts.device)
    res = klt_cuda.lk_track(prev, curr, pts, settings["win"], levels, m, settings["eps"], point_mask=mask,
                            initial_flow=flow, iterations=iterations, path=path)
    return klt.FlowResult(*res), iterations, path


def held_entries(points: torch.Tensor, mask: Optional[torch.Tensor], initial_flow: Optional[torch.Tensor]):
    """The entries held to eps: every entry of a call that starts each
    point where it is (the scan, the odometry), and the live ones
    (``mask``) of a call seeded with offsets. There the padding entries,
    two_view's unmatched match slots, start from arbitrary offsets, and the
    order of the window sums moves them by pixels whether they converge or
    not (up to 3.45 px converged and 38.4 px not, on the two-view path's
    input on an H100); the plain version on the card and on the CPU differ
    there as much."""
    every = torch.ones(len(points), dtype=torch.bool, device=points.device)
    return every if initial_flow is None or mask is None else mask.to(torch.bool)


def lk_agreement(got: klt.FlowResult, ref: klt.FlowResult, held: torch.Tensor) -> Dict[str, object]:
    """How the kernel's result ``got`` departs from the plain version's
    ``ref``: equal status and NaN patterns over every entry; the max and
    median point difference over the finite coordinates of the ``held``
    entries (``held_entries``); the max error difference where both points
    agree to 1e-4 (the same windows: a point whose update sits at the eps
    freeze threshold can take or skip it, since the card sums the windows
    in another order, and then reads other windows); and, printed only,
    the count of the other entries and their max point difference."""
    fin = ~ref.points.isnan()
    diff = (got.points[fin & held[:, None]] - ref.points[fin & held[:, None]]).abs()
    other = (got.points[fin & ~held[:, None]] - ref.points[fin & ~held[:, None]]).abs()
    same = ~ref.error.isnan() & ((got.points - ref.points).abs().amax(dim=1) <= 1e-4)
    err = (got.error[same] - ref.error[same]).abs()
    return {
        "status_equal": torch.equal(got.status, ref.status),
        "nan_equal": torch.equal(got.points.isnan(), ref.points.isnan())
        and torch.equal(got.error.isnan(), ref.error.isnan()),
        "held": int(held.sum()),
        "max_point": float(diff.max()) if diff.numel() else 0.0,
        "median_point": float(diff.median()) if diff.numel() else 0.0,
        "max_error": float(err.max()) if err.numel() else 0.0,
        "not_held": int((~held).sum()),
        "max_point_not_held": float(other.max()) if other.numel() else 0.0,
    }


def lk_agrees(a: Dict[str, object], eps: float) -> bool:
    """Status and NaN patterns equal, held points within ``eps`` with the
    median within 1e-4, errors within 1e-4."""
    return bool(a["status_equal"] and a["nan_equal"] and a["max_point"] <= eps and a["median_point"] <= 1e-4
                and a["max_error"] <= 1e-4)


def _reads(centres: torch.Tensor, pad: int, size: int, h: int, w: int) -> torch.Tensor:
    """(K, 4) inclusive pixel rectangles (y0, y1, x0, x1) that ``size`` x
    ``size`` bilinear windows around ``centres`` (K, 2) (x, y), placed on
    the image padded by ``pad``, read from an h x w level: ``place`` and
    ``pixel`` in ``csrc/klt.cu``, size + 1 pixels a side, clamped."""
    sides = []
    for v, n_px in ((centres[:, 1], h), (centres[:, 0], w)):
        t0 = torch.nan_to_num(torch.floor((v - 0.5 * (size - 1)) + pad), nan=0.0)
        start = t0.clamp(0, n_px + 2 * pad - size - 1).to(torch.int64) - pad
        sides += [start.clamp(0, n_px - 1), (start + size).clamp(0, n_px - 1)]
    return torch.stack(sides, dim=1)


def _covered(h: int, w: int, rects: torch.Tensor) -> int:
    """Pixels of an h x w level inside at least one of ``rects``."""
    if not len(rects):
        return 0
    y0, y1, x0, x1 = rects.unbind(1)
    row = w + 1
    corners = torch.cat([y0 * row + x0, y0 * row + x1 + 1, (y1 + 1) * row + x0, (y1 + 1) * row + x1 + 1])
    one = torch.ones_like(y0)
    diff = torch.zeros((h + 1) * row, dtype=torch.int64).index_add_(0, corners, torch.cat([one, -one, -one, one]))
    return int((diff.view(h + 1, row).cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def lk_work(shapes, points, win: int, iterations, path, tracked, status, with_flow: bool) -> Dict[str, int]:
    """Operations and bytes one call needed (see the module's note), and
    the dependent steps of the slowest point at each level, coarsest first
    (the template's staging and the G reduction, then one step an
    iteration): ``shapes`` the used levels' (H, W), level 0 first;
    ``points`` (N, 2) the call's; ``iterations`` (N, levels) and ``path``
    (N, levels, max_iters, 2) from the kernel; ``tracked`` (N, 2) and
    ``status`` (N,) its result."""
    points, iterations, path, tracked, status = (t.cpu() for t in (points, iterations, path, tracked, status))
    n, levels = iterations.shape
    px, tpl = win * win, (win + 2) * (win + 2)
    flops = n * levels * (11 * tpl + 10 * px) + int(iterations.sum()) * 16 * px + int(status.sum()) * 25 * px
    pixels = 0
    for lvl in range(levels):
        h, w = shapes[lvl]
        at = points.to(torch.float32) / 2**lvl
        ran = torch.arange(path.shape[2])[None, :] < iterations[:, lvl, None]
        prev = [_reads(at, win + 3, win + 2, h, w)]
        curr = [_reads((at[:, None, :] + path[:, lvl])[ran], win + 1, win, h, w)]
        if lvl == 0:
            prev.append(_reads(points[status], win + 1, win, h, w))
            curr.append(_reads(tracked[status], win + 1, win, h, w))
        pixels += _covered(h, w, torch.cat(prev)) + _covered(h, w, torch.cat(curr))
    nbytes = 4 * pixels + n * (8 + 1 + (8 if with_flow else 0)) + n * (8 + 1 + 4)
    steps = [2 + int(c) for c in iterations.flip(1).max(dim=0).values] if n else []
    return {"flops": flops, "bytes": nbytes, "steps": steps}


def time_lk(prev, curr, pts, mask, flow, settings) -> Dict[str, object]:
    """Kernel and plain times at one input, the work and bound, the share
    of the bound reached, and the per-level step counts."""
    res, iterations, path = lk_kernel(prev, curr, pts, mask, flow, settings)
    shapes = [tuple(p.shape) for p in prev[: iterations.shape[1]]]
    work = lk_work(shapes, pts, settings["win"], iterations, path, res.points, res.status, flow is not None)
    by_ops, by_bytes = work["flops"] / FP32_FLOPS_PER_S * 1e3, work["bytes"] / HBM_BYTES_PER_S * 1e3
    ms = time_ms(lambda: klt.lucas_kanade(prev, curr, pts, point_mask=mask, initial_flow=flow, **settings))
    plain = time_ms(lambda: klt.lucas_kanade_reference(prev, curr, pts, point_mask=mask, initial_flow=flow, **settings))
    bound = max(by_ops, by_bytes)
    return {
        "ms": ms, "plain_ms": plain, **work, "bound_ms": bound,
        "bound_by": "operations" if by_ops >= by_bytes else "bytes", "share": bound / ms,
        "mean_iterations": [float(c) for c in iterations.flip(1).float().mean(dim=0)],
        "shape": list(prev[0].shape), "points": len(pts),
    }


def describe(label: str, r: Dict[str, object]) -> str:
    return (f"lk_track {label} {tuple(r['shape'])} x {r['points']} points: {r['ms']:.6f} ms (plain {r['plain_ms']:.6f} "
            f"ms), {r['flops']} FLOP, {r['bytes']} B, bound {r['bound_ms']:.6f} ms by {r['bound_by']}, share "
            f"{r['share']:.4f}; dependent steps per level {r['steps']}, mean iterations {r['mean_iterations']}")


def ptxas() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        return cuda_build.compile_source(klt_cuda.SOURCE, Path(tmp) / "lib.so", (*klt_cuda.NVCC_EXTRA, "-Xptxas", "-v"))


def raw_launch(lib: ctypes.CDLL, case) -> Callable[[], None]:
    """One launch of ``lib``'s kernel on a (prev, curr, points, mask,
    initial flow, settings) case with no checks or counting, for timing two
    builds of the same C interface alike."""
    prev, curr, pts, mask, flow, s = case
    klt_cuda._bind(lib)
    levels, n = min(s["levels"], len(prev)), len(pts)
    pts = pts.to(torch.float32).contiguous()
    mask = (torch.ones(n, dtype=torch.bool, device=pts.device) if mask is None else mask).contiguous()
    flow = None if flow is None else flow.to(torch.float32).contiguous()
    out = (torch.empty((n, 2), device=pts.device), torch.empty(n, dtype=torch.bool, device=pts.device),
           torch.empty(n, device=pts.device))
    ptr = ctypes.c_void_p
    args = (
        (ptr * levels)(*[t.data_ptr() for t in prev[:levels]]), (ptr * levels)(*[t.data_ptr() for t in curr[:levels]]),
        (ctypes.c_int * levels)(*[t.shape[0] for t in prev[:levels]]),
        (ctypes.c_int * levels)(*[t.shape[1] for t in prev[:levels]]), levels, pts.data_ptr(),
        None if flow is None else flow.data_ptr(), mask.data_ptr(), n, s["win"], s["max_iters"], s["eps"] ** 2,
        *(t.data_ptr() for t in out), None, None, torch.cuda.current_stream(pts.device).cuda_stream,
    )

    def run():
        code = lib.lk_track(*args)
        if code != 0:
            raise RuntimeError(f"lk_track launch failed: cudaError {code}")

    run.outputs = out
    return run


def compare(source: Path, device, paths: bool) -> Dict[str, Dict[str, list]]:
    """Both libraries' kernels at the callers' seeded inputs, the edge
    cases and, with ``paths``, the paths' first calls, in turns other,
    this, this, other; prints and returns each input's medians (ms) per
    turn."""
    inputs = [(label, seeded_case(shape, s, n, shift, device) + (s,)) for label, shape, s, n, shift in CALLERS]
    inputs += [(case, lk_case(case, device)) for case in ("ragged", "deep_edges")]
    if paths:
        from meatmodeler_tpu_torch.tools.path_calls import record

        recorded = record(device, ("scan", "odometry", "two_view"))["lk"]
        inputs += [(f"{path} call", case) for path, case in recorded.items()]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.compile_source(source, Path(tmp) / "other.so", klt_cuda.NVCC_EXTRA)
        libs = {"other": ctypes.CDLL(str(Path(tmp) / "other.so")), "this": klt_cuda.build()}
        for label, case in inputs:
            runs = {name: raw_launch(lib, case) for name, lib in libs.items()}
            times = {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                times[which].append(time_ms(runs[which]))
            out[label] = times
            us = {which: [round(t * 1e3, 3) for t in ts] for which, ts in times.items()}
            print(f"compare lk_track {label} {tuple(case[0][0].shape)} x {len(case[2])} points {case[5]}: other "
                  f"{us['other']} us, this {us['this']} us")
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--compare", type=Path, default=None)
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("klt_bench: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.ptxas:
        print(ptxas())
    klt_cuda.build()
    for label, shape, settings, n, shift in CALLERS:
        print(describe(label, time_lk(*seeded_case(shape, settings, n, shift, dev), settings)))
    if args.compare is not None:
        compare(args.compare, dev, args.paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
