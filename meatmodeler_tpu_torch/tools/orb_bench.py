"""ORB's card kernels (``csrc/orb.cu``, launched by ``ops/clahe_cuda``) against
the plain path and their bounds, on one GPU.

    python3 -m meatmodeler_tpu_torch.tools.orb_bench [--ptxas] [--inputs known,video,batch,two_view]

Prints, with the card's name and power limit:

- with ``--ptxas``, each kernel's registers, stack, spills and shared memory
  (``orb.cu`` compiled once more with ``-Xptxas -v``);
- for each input, recorded as the paths hand it to ``detect_and_compute``
  (``record_inputs``): the known cell's keyframe stack (host pass 1, grey
  keyframes), the video cell's (LAB lightness), one video of the batch
  cell's and two-view's single 720p image; per level, each kernel's device
  time (``clahe_bench.time_ms``: medians of 25 launches, cold L2, the
  host's launch time hidden) beside the plain path's ops that it
  replaces, its work (``work``) and the bound the work sets, then the
  whole call on the card path and on the plain path (synced wall medians)
  and the CUDA launches of one call of each;
- the agreement of the kernels with the plain path at every level of every
  input (``level_agreement``, on the plain path's own level images) and of
  the two whole calls (``call_agreement``); exit 1 if a rule fails.

``reference_agreement`` holds a call's features to the JAX package's of
the same frames, stored as data (the card has no JAX), by
``REFERENCE_RULES``.

The rules (``RULES``), against the plain path on the same input: FAST
flags equal; blurred levels bit-identical; downscaled levels within 1e-4
grey levels; Harris responses within 1e-5 of the image's largest
|response|; at least 99.5% of the selected keypoints of each image and
level common, every difference a near-tie at the k-th response; angles of
common keypoints within 1e-5 rad, bins equal except where the plain angle
lies within 1e-5 of a bin edge; descriptors bit-identical wherever the bins
agree. The plain path sums the orientation's moments in float32, and on
non-integer levels (CLAHE output, downscales) that sum alone moves some
angles by more than 1e-5 rad (up to 1.0e-4 on the known cell's keyframes,
H100). So an angle holds where it lies within 1e-5 rad of the exact angle
(the same float32 products summed in float64, ``exact_orientation``) and
within 1e-5 rad plus the plain angle's own distance from the exact one of
the plain angle; the count beyond a bare 1e-5 is printed (``over_rule``).
The whole call's levels past the first start from each path's own
downscale, so there each path's angles are held to the exact angle on its
own level images, and the gap between the two may grow by the distance
between those two exact angles.

``work`` counts bytes as each input read once and each output written once
(the describe kernel: the pixels its keypoints' patches and windows cover,
each once) and operations as the algorithm needs them: a blurred pixel 26
(two 7-tap passes), a downscaled one 2 ny nx + 2 nx, a response 98 (Sobel
10, products 3, a separable 7 x 7 box 36, Harris 7, FAST 34, NMS 8), a
keypoint 4 a pixel of its 709-pixel circle and 7 a BRIEF sample plus 256
comparisons. The bound is the larger of bytes at 3.35 TB/s and operations
at 67 TFLOP/s.
"""

from __future__ import annotations

import argparse
import functools
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from meatmodeler_tpu_torch.ops import clahe_cuda, cuda_build, orb
from meatmodeler_tpu_torch.ops import features as feat

__all__ = ["INPUTS", "REFERENCE_RULES", "RULES", "call_agreement", "card_levels", "level_agreement", "record_inputs",
           "reference_agreement", "time_input", "work"]

INPUTS = ("known", "video", "batch", "two_view")
RULES = {"resize": 1e-4, "harris": 1e-5, "common": 0.995, "angle": 1e-5}
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
BIN_WIDTH = 2.0 * math.pi / orb._NBINS
_CIRCLE = sum(1 for y in range(-15, 16) for x in range(-15, 16) if y * y + x * x <= 225)


@functools.lru_cache(maxsize=None)
def record_inputs(names=INPUTS) -> Dict[str, tuple]:
    """{name: (stack (B, H, W) float32 on the card, detect_and_compute's
    keyword arguments)}: the first call each path makes (see the module's
    note); renders and runs the paths on the card."""
    from meatmodeler_tpu_torch.io.synthetic import render_sequence
    from meatmodeler_tpu_torch.parallel.batch import process_batch
    from meatmodeler_tpu_torch.pipeline import process
    from meatmodeler_tpu_torch.tools.profile_headline import (
        BATCH_FRAMES, BATCH_SEEDS, batch_config, detector_config, headline_clip, headline_config, headline_scene,
        markerless_clip, recording,
    )
    from meatmodeler_tpu_torch.two_view import reconstruct_two_view

    def first(run):
        with recording(orb, "detect_and_compute") as calls:
            run()
        args, kwargs = calls[0]
        img = args[0].to(torch.float32)
        return (img if img.ndim == 3 else img[None]).contiguous(), dict(kwargs)

    out = {}
    if {"known", "video"} & set(names):
        scene, frames, corners = headline_clip("cuda")
        if "known" in names:
            out["known"] = first(lambda: process(frames, config=headline_config(), known_corners=corners, device="cuda"))
        if "video" in names:
            out["video"] = first(lambda: process(frames, config=detector_config(headline_config()), device="cuda"))
        del frames
    if "batch" in names:
        clip = render_sequence(headline_scene(), BATCH_FRAMES, seed=BATCH_SEEDS[0], backend="torch", device="cuda")[0]
        out["batch"] = first(lambda: process_batch([clip], config=batch_config(), device="cuda"))
    if "two_view" in names:
        scene, frames, _ = markerless_clip("cuda")
        out["two_view"] = first(lambda: reconstruct_two_view(frames[0], frames[4], scene.intrinsics, device="cuda"))
    return out


def _settings(kwargs):
    return (kwargs.get("max_features", 4096), kwargs.get("num_levels", 4), kwargs.get("scale_factor", 1.2),
            kwargs.get("fast_threshold", 20.0), kwargs.get("grid_cells", 0))


def _plain_masked(img, threshold):
    """The plain path's FAST flags, Harris response and masked response."""
    h, w = img.shape[-2:]
    corner = orb.fast_score(img, threshold) > 0
    harris = feat.harris_response(img, block_size=7)
    resp = torch.where(corner, harris, torch.full_like(harris, -torch.inf))
    neigh = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    m = orb._HALF + 1
    ok = (resp >= neigh) & (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    return corner, harris, torch.where(ok, resp, torch.full_like(resp, -torch.inf))


def _bins(angle):
    bw = torch.tensor(BIN_WIDTH, dtype=torch.float32, device=angle.device)
    return torch.remainder(torch.round(angle / bw).to(torch.int64), orb._NBINS)


def _near_edge(angle):
    """Where an angle lies within the angle rule of a bin edge."""
    pos = angle.double() / BIN_WIDTH - 0.5
    return (pos - torch.round(pos)).abs() * BIN_WIDTH <= RULES["angle"]


def _selection_agreement(resp_a, idx_a, resp_b, idx_b, ref_resp_flat, kth, scale):
    """Common share of two selections of one image (plain ``a``), and
    whether every keypoint in one only is a near-tie at the k-th response."""
    sa = set(idx_a[torch.isfinite(resp_a)].tolist())
    sb = set(idx_b[torch.isfinite(resp_b)].tolist())
    common = len(sa & sb) / max(len(sa), 1) if sa or sb else 1.0
    diff = sorted(sa ^ sb)
    ties = all(abs(float(ref_resp_flat[i]) - kth) <= RULES["harris"] * scale for i in diff)
    return common, len(diff), ties


def level_agreement(img: torch.Tensor, k: int, next_size, threshold: float = 20.0, grid_cells: int = 0):
    """The kernels against the plain path at one level (``img`` (B, H, W) on
    the card): the worst reading of each rule and whether all hold."""
    blur, nxt = clahe_cuda.orb_level_build(img, next_size)
    masked, raw = clahe_cuda.orb_response(img, threshold, margin=orb._HALF + 1, raw=True)
    corner, harris, p_masked = _plain_masked(img, threshold)
    scale = harris.flatten(1).abs().amax(1).clamp_min(1e-30)
    out = {
        "fast_equal": bool(torch.equal(torch.isfinite(raw), corner)),
        "blur_bits": bool(torch.equal(blur, orb._gauss7(img))),
        "resize": float((nxt - orb._resize(img, *next_size)).abs().max()) if next_size else 0.0,
        "harris": float(torch.where(corner, (raw - harris).abs(), torch.zeros_like(raw)).flatten(1).amax(1)
                        .div(scale).max()),
    }
    p_resp, p_idx, p_xy, p_mask = orb._select(p_masked, k, grid_cells)
    c_resp, c_idx, _, _ = orb._select(masked, k, grid_cells)
    commons, diffs, ties = [], 0, True
    for i in range(img.shape[0]):
        fin = p_resp[i][torch.isfinite(p_resp[i])]
        kth = float(fin.min()) if fin.numel() else 0.0
        c, d, t = _selection_agreement(p_resp[i], p_idx[i], c_resp[i], c_idx[i], harris[i].flatten(), kth, float(scale[i]))
        commons.append(c)
        diffs, ties = diffs + d, ties and t
    out.update(common=min(commons), differing=diffs, near_ties=ties)
    # Orientation and description at the plain path's keypoints.
    angle, desc = clahe_cuda.orb_describe(img, blur, p_idx, p_resp, BIN_WIDTH)
    p_blur = orb._gauss7(img)
    p_angle = torch.stack([orb._orientation(img[i], p_xy[i], p_mask[i]) for i in range(img.shape[0])])
    p_desc = torch.stack([orb._describe(p_blur[i], p_xy[i], p_angle[i], p_mask[i]) for i in range(img.shape[0])])
    exact = torch.stack([exact_orientation(img[i], p_xy[i], p_mask[i]) for i in range(img.shape[0])])
    out.update(_describe_agreement(angle, desc, p_angle, p_desc, p_mask, exact))
    out["ok"] = (out["fast_equal"] and out["blur_bits"] and out["resize"] <= RULES["resize"]
                 and out["harris"] <= RULES["harris"] and out["common"] >= RULES["common"] and out["near_ties"]
                 and out["angle_ok"] and out["desc_equal"])
    return out


def exact_orientation(img, xy, mask):
    """``orb._orientation`` with its float32 products summed in float64 and
    the angle taken in float64: the angle the plain path's float32 sums
    round."""
    h, w = img.shape
    d = torch.arange(-orb._HALF, orb._HALF + 1, dtype=img.dtype, device=img.device)
    circ = ((d[:, None] ** 2 + d[None, :] ** 2) <= orb._HALF**2).to(img.dtype)
    ar = torch.arange(orb._PATCH, device=img.device)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - orb._HALF, 0, w - orb._PATCH)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - orb._HALF, 0, h - orb._PATCH)
    patch = img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]] * circ
    m01 = (patch * d[:, None]).double().sum(dim=(1, 2))
    m10 = (patch * d[None, :]).double().sum(dim=(1, 2))
    return torch.where(mask, torch.atan2(m01, m10), torch.zeros_like(m01))


def _describe_agreement(angle, desc, p_angle, p_desc, mask, exact=None, p_exact=None):
    """Angles, bins and descriptors against the plain path's. With the
    exact angles (``exact_orientation``: ``exact`` on the card's level
    images, ``p_exact`` on the plain path's, the same by default), an angle
    holds where it lies within the rule of its exact angle and within the
    rule plus the plain angle's own rounding error plus the distance
    between the two exact angles of the plain angle; without, it is only
    reported."""
    same_bin = _bins(angle) == _bins(p_angle)
    gap = torch.where(mask, (angle - p_angle).abs(), torch.zeros_like(angle))
    bins_ok = bool((same_bin | ~mask | _near_edge(p_angle)).all())
    out = {
        "angle": float(gap.max()) if gap.numel() else 0.0,
        "bins_differ": int((~same_bin & mask).sum()),
        "angle_ok": bins_ok,
        "desc_equal": bool(torch.equal(desc[same_bin], p_desc[same_bin])),
    }
    if exact is not None and gap.numel():
        p_exact = exact if p_exact is None else p_exact
        zero = torch.zeros_like(exact)
        own = torch.where(mask, (p_angle.double() - p_exact).abs(), zero)
        card = torch.where(mask, (angle.double() - exact).abs(), zero)
        shift = torch.where(mask, (exact - p_exact).abs(), zero)
        out.update(
            over_rule=int((gap > RULES["angle"]).sum()),
            plain_exact=float(own.max()),
            card_exact=float(card.max()),
            exact_shift=float(shift.max()),
            angle_ok=bins_ok and bool((card <= RULES["angle"]).all())
            and bool((gap <= RULES["angle"] + own + shift).all()),
        )
    return out


def call_agreement(stack: torch.Tensor, **kwargs):
    """A whole card ``detect_and_compute`` call against the plain path's on
    the same stack: per image and level the common share of the keypoints
    (the least), and angles, bins and descriptors of the common ones, the
    angles held to the exact angles on each path's own level images."""
    max_features, num_levels, scale_factor = _settings(kwargs)[:3]
    card = orb.detect_and_compute(stack, **kwargs)
    plain = orb._detect_plain(stack, *_settings(kwargs))
    p_levels = [img for img, _, _ in plain_levels(stack, max_features, num_levels, scale_factor)]
    c_levels = card_levels(stack, num_levels, scale_factor)
    commons, rows = [], []
    for i in range(stack.shape[0]):
        for lvl in range(int(plain.octave[i].max()) + 1):
            def keyed(f):
                sel = (f.octave[i] == lvl) & f.mask[i]
                keys = (f.xy[i][sel, 1] * 1e5 + f.xy[i][sel, 0]).tolist()
                return dict(zip(keys, torch.nonzero(sel)[:, 0].tolist()))

            kp, kc = keyed(plain), keyed(card)
            common = sorted(kp.keys() & kc.keys())
            commons.append(len(common) / max(len(kp), 1) if kp or kc else 1.0)
            p, c = [kp[k] for k in common], [kc[k] for k in common]
            # The keypoints' pixels on their level, from the level-0 positions.
            lxy = torch.round(card.xy[i, c] / scale_factor**lvl)
            ones = torch.ones(len(c), dtype=torch.bool, device=stack.device)
            rows.append((i, p, c, exact_orientation(c_levels[lvl][i], lxy, ones),
                         exact_orientation(p_levels[lvl][i], lxy, ones)))
    pa = torch.cat([plain.angle[r[0], r[1]] for r in rows])
    ca = torch.cat([card.angle[r[0], r[2]] for r in rows])
    pd = torch.cat([plain.descriptors[r[0], r[1]] for r in rows])
    cd = torch.cat([card.descriptors[r[0], r[2]] for r in rows])
    exact, p_exact = torch.cat([r[3] for r in rows]), torch.cat([r[4] for r in rows])
    out = {"common": min(commons),
           **_describe_agreement(ca, cd, pa, pd, torch.ones_like(pa, dtype=torch.bool), exact, p_exact)}
    out["ok"] = out["common"] >= RULES["common"] and out["angle_ok"] and out["desc_equal"]
    return out


# The port against the JAX package's features of the same frames: at least
# 99% of each image's slots identical (validity, position, octave), and on
# the slots valid in both angles within 1e-4 rad, bins equal except where
# the reference angle lies within 1e-4 of a bin edge, descriptors
# bit-identical where the bins agree, responses within rtol 1e-4
# (``tests/test_torch_orb_matching.py``'s bounds).
REFERENCE_RULES = {"slots": 0.99, "angle": 1e-4, "response_rtol": 1e-4}


def reference_agreement(feats, ref) -> dict:
    """``feats`` (``OrbFeatures`` of a (B, H, W) stack) against ``ref``,
    the JAX package's features of the same frames as numpy arrays (``xy``,
    ``response``, ``angle``, ``octave``, ``mask``, and ``descriptors``
    packed eight bits a byte): the worst reading of each rule
    (``REFERENCE_RULES``) and whether all hold."""
    f = {k: getattr(feats, k).cpu().numpy() for k in ("xy", "response", "angle", "octave", "mask")}
    desc = np.packbits(feats.descriptors.cpu().numpy().astype(np.uint8), axis=-1)
    same = (f["mask"] == ref["mask"]) & (f["octave"] == ref["octave"])
    same &= ~ref["mask"] | np.all(f["xy"] == ref["xy"], axis=-1)
    both = same & ref["mask"]
    angle, ref_angle = f["angle"][both], ref["angle"][both]
    rule = REFERENCE_RULES["angle"]
    pos = ref_angle.astype(np.float64) / BIN_WIDTH - 0.5
    near_edge = np.abs(pos - np.round(pos)) * BIN_WIDTH <= rule
    same_bin = _bins(torch.from_numpy(angle)).numpy() == _bins(torch.from_numpy(ref_angle)).numpy()
    resp_gap = np.abs(f["response"][both] - ref["response"][both]) / np.maximum(np.abs(ref["response"][both]), 1e-30)
    out = {
        "slots": float(same.mean(axis=1).min()),
        "valid": int(ref["mask"].sum()),
        "angle": float(np.abs(angle - ref_angle).max(initial=0.0)),
        "bins_differ": int((~same_bin).sum()),
        "desc_equal": bool(np.array_equal(desc[both][same_bin], ref["descriptors"][both][same_bin])),
        "response_rtol": float(resp_gap.max(initial=0.0)),
    }
    out["ok"] = (out["slots"] >= REFERENCE_RULES["slots"] and out["angle"] <= rule
                 and bool((same_bin | near_edge).all()) and out["desc_equal"]
                 and out["response_rtol"] <= REFERENCE_RULES["response_rtol"])
    return out


def plain_levels(stack, max_features, num_levels, scale_factor):
    """(level image, k, next size or None) of each level, by the plain
    path's downscale."""
    img, out = stack, []
    for lvl, budget in enumerate(orb._level_budgets(max_features, num_levels, scale_factor)):
        h, w = img.shape[-2:]
        nxt = orb._next_size(h, w, scale_factor) if lvl < num_levels - 1 else None
        out.append((img, max(budget, 1), nxt))
        if nxt:
            img = orb._resize(img, *nxt).contiguous()
    return out


def card_levels(stack, num_levels, scale_factor):
    """Each level's image as the card path builds it (``orb_level_build``)."""
    img, out = stack, []
    for lvl in range(num_levels):
        out.append(img)
        if lvl < num_levels - 1:
            img = clahe_cuda.orb_level_build(img, orb._next_size(*img.shape[-2:], scale_factor))[1]
    return out


def work(img, next_size, p_idx=None, p_resp=None) -> Dict[str, Dict[str, float]]:
    """{kernel: {"bytes", "flops"}} at one level (see the module's note);
    the describe kernel's at the keypoints ``p_idx`` / ``p_resp``."""
    b, h, w = img.shape
    px = b * h * w
    out = {"orb_response": {"bytes": 8.0 * px, "flops": 98.0 * px}}
    lvl = {"bytes": 8.0 * px, "flops": 26.0 * px}
    if next_size:
        nh, nw = next_size
        ny, nx = orb._resize_taps(h, nh)[1].shape[1], orb._resize_taps(w, nw)[1].shape[1]
        lvl["bytes"] += 4.0 * b * nh * nw + 4.0 * (nh * (1 + ny) + nw * (1 + nx))
        lvl["flops"] += (2.0 * ny * nx + 2.0 * nx) * b * nh * nw
    out["orb_level"] = lvl
    if p_idx is not None:
        valid = torch.isfinite(p_resp)
        hit = torch.zeros((b, 1, h, w), device=img.device)
        hit.view(b, -1).scatter_reduce_(1, torch.where(valid, p_idx, 0), valid.to(hit.dtype), "amax")
        covered = [int((F.max_pool2d(hit, 2 * r + 1, stride=1, padding=r) > 0).sum()) for r in (15, 20)]
        n = int(valid.sum())
        slots = p_idx.numel()
        out["orb_describe"] = {
            "bytes": 4.0 * sum(covered) + slots * (8 + 4 + 4 + 256) + orb._brief_table().nbytes,
            "flops": n * (4.0 * _CIRCLE + 7.0 * 512 + 256),
        }
    return out


def _bound_ms(w):
    return max(w["bytes"] / HBM_BYTES_PER_S, w["flops"] / FP32_FLOPS_PER_S) * 1e3


def _bound_by(w):
    return "bytes" if w["bytes"] / HBM_BYTES_PER_S >= w["flops"] / FP32_FLOPS_PER_S else "operations"


def _wall_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def launches(fn) -> int:
    """CUDA kernels, copies and memsets one ``fn()`` puts on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def time_input(stack, kwargs) -> List[dict]:
    """Per level, each kernel's device time beside the plain path's ops
    that it replaces (``plain_ms``), its work and bound."""
    from meatmodeler_tpu_torch.tools.clahe_bench import time_ms

    max_features, num_levels, scale_factor, threshold, grid_cells = _settings(kwargs)
    rows = []
    for lvl, (img, k, nxt) in enumerate(plain_levels(stack, max_features, num_levels, scale_factor)):
        blur, _ = clahe_cuda.orb_level_build(img, nxt)
        masked = clahe_cuda.orb_response(img, threshold, margin=orb._HALF + 1)
        resp, idx, kxy, kmask = orb._select(masked, k, grid_cells)
        w = work(img, nxt, idx, resp)

        def plain_describe():
            p_blur = orb._gauss7(img)
            for i in range(img.shape[0]):
                angle = orb._orientation(img[i], kxy[i], kmask[i])
                orb._describe(p_blur[i], kxy[i], angle, kmask[i])

        timed = {
            "orb_level": (lambda: clahe_cuda.orb_level_build(img, nxt),
                          lambda: (orb._gauss7(img), orb._resize(img, *nxt) if nxt else None)),
            "orb_response": (lambda: clahe_cuda.orb_response(img, threshold, margin=orb._HALF + 1),
                             lambda: _plain_masked(img, threshold)),
            "orb_describe": (lambda: clahe_cuda.orb_describe(img, blur, idx, resp, BIN_WIDTH), plain_describe),
        }
        for name, (kernel, plain) in timed.items():
            t = time_ms(kernel)
            rows.append({"level": lvl, "kernel": name, "shape": tuple(img.shape), "ms": t,
                         "plain_ms": time_ms(plain, reps=5), **w[name], "bound_ms": _bound_ms(w[name]),
                         "bound_by": _bound_by(w[name]), "share": _bound_ms(w[name]) / t})
    return rows


def ptxas() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        return cuda_build.compile_source(cuda_build.CSRC / "orb.cu", Path(tmp) / "lib.so", ("-Xptxas", "-v"))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--inputs", default=",".join(INPUTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("orb_bench: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {_card()}")
    if args.ptxas:
        print(ptxas())
    clahe_cuda.build()
    names = tuple(n for n in INPUTS if n in args.inputs.split(","))
    failed = 0
    for name, (stack, kwargs) in record_inputs(names).items():
        max_features, num_levels, scale_factor, threshold, grid_cells = _settings(kwargs)
        print(f"{name}: stack {tuple(stack.shape)}, {kwargs}")
        for row in time_input(stack, kwargs):
            print(f"  level {row['level']} {row['shape']} {row['kernel']}: {row['ms'] * 1e3:.3f} us "
                  f"(plain {row['plain_ms'] * 1e3:.3f} us); "
                  f"{row['bytes']:.0f} B, {row['flops']:.0f} operations; bound {row['bound_ms'] * 1e3:.3f} us, "
                  f"share {row['share']:.3f}")
        card = _wall_ms(lambda: orb.detect_and_compute(stack, **kwargs), 10)
        plain = _wall_ms(lambda: orb._detect_plain(stack, *_settings(kwargs)), 3)
        print(f"  whole call: card {card:.3f} ms, plain path {plain:.3f} ms (synced wall medians); CUDA launches "
              f"card {launches(lambda: orb.detect_and_compute(stack, **kwargs))}, plain "
              f"{launches(lambda: orb._detect_plain(stack, *_settings(kwargs)))}")
        for lvl, (img, k, nxt) in enumerate(plain_levels(stack, max_features, num_levels, scale_factor)):
            a = level_agreement(img, k, nxt, threshold, grid_cells)
            failed += not a["ok"]
            print(f"  agreement level {lvl}: {a}")
        a = call_agreement(stack, **kwargs)
        failed += not a["ok"]
        print(f"  agreement whole call: {a}")
    print(f"agreement: {'all rules hold' if not failed else f'{failed} comparisons break a rule'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
