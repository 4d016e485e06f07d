"""ORB: FAST corners + Harris ranking + intensity-centroid orientation +
steered BRIEF (torch twin of ``meatmodeler_tpu/ops/orb.py``).

Batched over a (B, H, W) stack of keyframes. The descriptor is the
reference's bit for bit in intent: the same seeded sampling pattern
(``_make_brief_pattern``, copied here because ``orb.py`` imports JAX), the
same 30-bin angle quantisation, and the same rounding — the reference
samples through a bfloat16 (bins x taps) weight matmul, so the blurred
pixels and the bilinear tap weights are rounded to bfloat16 here as well.
What differs is the mechanism: the four bilinear taps of each sample are
gathered directly instead of through the 52 MB ``brief_bin_weights``
matmul, a TPU workaround.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from meatmodeler_tpu_torch.ops import features as feat

__all__ = ["OrbFeatures", "fast_score", "detect_and_compute"]

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx).
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_PATCH = 31  # description patch (ORB's PATCH_SIZE)
_HALF = _PATCH // 2
_NBITS = 256
_NBINS = 30  # steering angle bins
_DPATCH = 41  # sampling window that covers the rotated pattern (+1 bilinear)
_DHALF = _DPATCH // 2
_CHUNK = 8  # images per detection pass (bounds the (B, 16, H, W) ring stack)


class OrbFeatures(NamedTuple):
    xy: torch.Tensor  # (..., K, 2) float32 (x, y) at level-0 scale
    response: torch.Tensor  # (..., K) Harris score
    angle: torch.Tensor  # (..., K) orientation in radians
    octave: torch.Tensor  # (..., K) int32 pyramid level
    descriptors: torch.Tensor  # (..., K, 256) int8 bits in {0, 1}
    mask: torch.Tensor  # (..., K) bool


def _make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) sample-pair offsets, Gaussian sigma = patch/5, clipped
    inside the patch — the reference's construction, same seed and
    arithmetic (``meatmodeler_tpu/ops/orb.py::_make_brief_pattern``)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=_PATCH / 5.0, size=(_NBITS, 2, 2))
    return np.clip(np.round(pts), -_HALF + 2, _HALF - 2).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _brief_taps():
    """Per angle bin, the four bilinear taps of each of the 512 samples
    (256 pairs x 2 endpoints; rows 0..255 endpoint A, 256..511 B): window
    rows (NBINS, 512, 4), columns, and weights rounded to bfloat16 as the
    reference's weight matrix is. Tap order is the reference's flat order
    (00, 01, 10, 11), which is also the order the taps are summed in."""
    pat = _make_brief_pattern().astype(np.float64)
    rows = np.zeros((_NBINS, 512, 4), np.int64)
    cols = np.zeros((_NBINS, 512, 4), np.int64)
    wts = np.zeros((_NBINS, 512, 4), np.float32)
    for b in range(_NBINS):
        ang = 2.0 * np.pi * b / _NBINS
        c, s = np.cos(ang), np.sin(ang)
        dy, dx = pat[..., 0], pat[..., 1]  # (256, 2)
        rx = c * dx - s * dy + _DHALF
        ry = s * dx + c * dy + _DHALF
        x0 = np.clip(np.floor(rx).astype(int), 0, _DPATCH - 2)
        y0 = np.clip(np.floor(ry).astype(int), 0, _DPATCH - 2)
        fx, fy = rx - x0, ry - y0
        for e in range(2):
            r = np.arange(256) + 256 * e
            rows[b, r] = np.stack([y0[:, e], y0[:, e], y0[:, e] + 1, y0[:, e] + 1], -1)
            cols[b, r] = np.stack([x0[:, e], x0[:, e] + 1, x0[:, e], x0[:, e] + 1], -1)
            wts[b, r] = np.stack(
                [
                    (1 - fy[:, e]) * (1 - fx[:, e]),
                    (1 - fy[:, e]) * fx[:, e],
                    fy[:, e] * (1 - fx[:, e]),
                    fy[:, e] * fx[:, e],
                ],
                -1,
            )
    wts_bf16 = torch.from_numpy(wts).to(torch.bfloat16).to(torch.float32)
    return torch.from_numpy(rows), torch.from_numpy(cols), wts_bf16


def fast_score(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9/16 segment test on (H, W) or (B, H, W): 1.0 where >= 9
    contiguous ring neighbours are all brighter than p + t or all darker
    than p - t."""
    if img.ndim == 2:
        return fast_score(img[None], threshold)[0]
    h, w = img.shape[-2:]
    padded = F.pad(img[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    ring = torch.stack([padded[:, 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in _RING], dim=1)

    def has_arc(flags):
        doubled = torch.cat([flags, flags[:, :7]], dim=1)  # (B, 23, H, W)
        csum = torch.cumsum(doubled, dim=1)
        csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
        return torch.amax(csum[:, 9:] - csum[:, :-9], dim=1) >= 9

    brighter = (ring > img[:, None] + threshold).to(torch.int16)
    darker = (ring < img[:, None] - threshold).to(torch.int16)
    return (has_arc(brighter) | has_arc(darker)).to(img.dtype)


def _orientation(img: torch.Tensor, xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle over the circular 31x31 patch, per image."""
    h, w = img.shape
    d = torch.arange(-_HALF, _HALF + 1, dtype=img.dtype, device=img.device)
    circ = ((d[:, None] ** 2 + d[None, :] ** 2) <= _HALF**2).to(img.dtype)
    ar = torch.arange(_PATCH, device=img.device)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - _HALF, 0, w - _PATCH)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - _HALF, 0, h - _PATCH)
    patch = img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]] * circ
    m01 = torch.sum(patch * d[:, None], dim=(1, 2))
    m10 = torch.sum(patch * d[None, :], dim=(1, 2))
    return torch.where(mask, torch.atan2(m01, m10), torch.zeros_like(m01))


def _describe(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF bits (K, 256) int8 for one (H, W) blurred image."""
    h, w = blurred.shape
    pad = _DHALF + 1
    padded = F.pad(blurred[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    padded = padded.to(torch.bfloat16).to(torch.float32).reshape(-1)
    wp = w + 2 * pad
    rows, cols, wts = (t.to(blurred.device) for t in _brief_taps())
    # Window top-left in padded coordinates (centre at +_DHALF).
    x0 = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1) + 1
    y0 = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1) + 1
    bin_width = torch.tensor(2.0 * math.pi / _NBINS, dtype=torch.float32, device=angle.device)
    bin_idx = torch.remainder(torch.round(angle / bin_width).to(torch.int64), _NBINS)
    flat = (y0[:, None, None] + rows[bin_idx]) * wp + (x0[:, None, None] + cols[bin_idx])
    taps = padded[flat] * wts[bin_idx]  # (K, 512, 4); bf16 x bf16 products are exact
    vals = ((taps[..., 0] + taps[..., 1]) + taps[..., 2]) + taps[..., 3]
    bits = (vals[:, :_NBITS] < vals[:, _NBITS:]).to(torch.int8)
    return torch.where(mask[:, None], bits, torch.zeros_like(bits))


def _gauss7(img: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian (sigma 2) blur, separable, edge-padded, summed in the
    reference's tap order."""
    g = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    g = (g / g.sum()).astype(np.float32)
    h, w = img.shape[-2:]
    p = F.pad(img[:, None], (0, 0, 3, 3), mode="replicate")[:, 0]
    tmp = float(g[0]) * p[:, 0:h]
    for i in range(1, 7):
        tmp = tmp + float(g[i]) * p[:, i : i + h]
    p = F.pad(tmp[:, None], (3, 3, 0, 0), mode="replicate")[:, 0]
    out = float(g[0]) * p[:, :, 0:w]
    for i in range(1, 7):
        out = out + float(g[i]) * p[:, :, i : i + w]
    return out


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) antialiased triangle-kernel weights of
    ``jax.image.resize(..., "linear")`` (``jax._src.image.scale``), in
    float64 then cast to float32 as the reference's test runs compute them."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    wts = np.maximum(0.0, 1.0 - x)
    tot = wts.sum(axis=0, keepdims=True)
    wts = np.where(
        np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
        wts / np.where(tot != 0, tot, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], wts, 0).astype(np.float32)


def _resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Antialiased bilinear downscale of (B, H, W) (separable weight matmuls;
    F.interpolate does not antialias the same way)."""
    h, w = img.shape[-2:]
    wy = torch.from_numpy(_resize_weights(h, nh)).to(img.device)
    wx = torch.from_numpy(_resize_weights(w, nw)).to(img.device)
    return torch.einsum("bhw,hH,wW->bHW", img, wy, wx)


def _level_budgets(max_features: int, num_levels: int, scale_factor: float):
    inv_total = (1.0 - 1.0 / scale_factor) / (1.0 - (1.0 / scale_factor) ** num_levels)
    budgets, rem = [], max_features
    for lvl in range(num_levels):
        if lvl == num_levels - 1:
            budgets.append(rem)
        else:
            b = min(int(round(max_features * inv_total * (1.0 / scale_factor) ** lvl)), rem)
            budgets.append(b)
            rem -= b
    return budgets


def _top_k(x: torch.Tensor, k: int):
    """Exact top-k along the last dim; a stable sort breaks ties toward the
    lower index, as ``lax.top_k`` does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _grid_top_k(resp: torch.Tensor, k: int, g: int):
    """The reference's bucketed selection on (B, H, W) responses: pad to a
    multiple of ``g`` with -inf, keep the best ceil(k / g^2) of each of the
    g x g cells, then rank the survivors globally. Returns (responses,
    flat pixel indices), at most ``k`` per image; candidates from the
    padded strip keep -inf and an index clamped into the image."""
    bsz, h, w = resp.shape
    ph, pw = -h % g, -w % g
    padded = F.pad(resp, (0, pw, 0, ph), value=-torch.inf)
    ch, cw = (h + ph) // g, (w + pw) // g
    cells = padded.reshape(bsz, g, ch, g, cw).permute(0, 1, 3, 2, 4).reshape(bsz, g * g, ch * cw)
    c_resp, c_idx = _top_k(cells, min(-(-k // (g * g)), ch * cw))
    ci = torch.arange(g * g, device=resp.device)[:, None]
    cy = (ci // g) * ch + c_idx // cw
    cx = (ci % g) * cw + c_idx % cw
    cand_idx = (torch.clamp(cy, max=h - 1) * w + torch.clamp(cx, max=w - 1)).reshape(bsz, -1)
    cand_resp = c_resp.reshape(bsz, -1)
    top_resp, sel = _top_k(cand_resp, min(k, h * w, cand_resp.shape[1]))
    return top_resp, torch.gather(cand_idx, 1, sel)


def _detect_chunk(img, max_features, num_levels, scale_factor, fast_threshold, grid_cells):
    bsz = img.shape[0]
    level_img = img
    outs = []
    for lvl, budget in enumerate(_level_budgets(max_features, num_levels, scale_factor)):
        k = max(budget, 1)
        h, w = level_img.shape[-2:]
        corner = fast_score(level_img, fast_threshold)
        harris = feat.harris_response(level_img, block_size=7)
        resp = torch.where(corner > 0, harris, torch.full_like(harris, -torch.inf))
        # 3x3 NMS (max_pool pads with -inf, like reduce_window's init) + margin.
        neigh = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
        yy = torch.arange(h, device=img.device)[:, None]
        xx = torch.arange(w, device=img.device)[None, :]
        margin = _HALF + 1
        ok = (resp >= neigh) & (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)
        masked = torch.where(ok, resp, torch.full_like(resp, -torch.inf))
        if grid_cells > 1 and h >= grid_cells and w >= grid_cells:
            top_resp, top_idx = _grid_top_k(masked, k, grid_cells)
        else:
            top_resp, top_idx = _top_k(masked.reshape(bsz, -1), min(k, h * w))
        k_eff = top_resp.shape[1]
        if k_eff < k:
            top_resp = F.pad(top_resp, (0, k - k_eff), value=-torch.inf)
            top_idx = F.pad(top_idx, (0, k - k_eff))
        kxy = torch.stack([(top_idx % w).to(torch.float32), (top_idx // w).to(torch.float32)], dim=-1)
        kmask = torch.isfinite(top_resp)

        blurred = _gauss7(level_img)
        angle = torch.stack([_orientation(level_img[i], kxy[i], kmask[i]) for i in range(bsz)])
        desc = torch.stack([_describe(blurred[i], kxy[i], angle[i], kmask[i]) for i in range(bsz)])
        outs.append(
            OrbFeatures(
                xy=kxy * (scale_factor**lvl),
                response=torch.where(kmask, top_resp, torch.full_like(top_resp, -torch.inf)),
                angle=angle.to(torch.float32),
                octave=torch.full((bsz, k), lvl, dtype=torch.int32, device=img.device),
                descriptors=desc,
                mask=kmask,
            )
        )
        if lvl < num_levels - 1:
            nh = max(int(round(h / scale_factor)), _PATCH + 2)
            nw = max(int(round(w / scale_factor)), _PATCH + 2)
            level_img = _resize(level_img, nh, nw)
    return OrbFeatures(*(torch.cat(parts, dim=1) for parts in zip(*outs)))


def detect_and_compute(
    img: torch.Tensor,
    max_features: int = 4096,
    num_levels: int = 4,
    scale_factor: float = 1.2,
    fast_threshold: float = 20.0,
    bin_weights=None,
    topk_recall: float = 0.95,
    grid_cells: int = 0,
) -> OrbFeatures:
    """Oriented-FAST detection + rBRIEF description over a scale pyramid.

    ``img`` is (H, W) or (B, H, W) grey in [0, 255]; outputs carry the same
    leading dims. ``grid_cells`` > 1: each level's corners are ranked
    within a ``grid_cells`` x ``grid_cells`` grid of cells first, so weak-
    texture regions keep their best corners (the reference's bucketed
    selection; levels smaller than the grid rank globally).
    ``bin_weights`` and ``topk_recall`` are accepted in the reference's
    positions and ignored: they tune its TPU-only BRIEF matmul and
    approximate top-k, and the port samples and ranks exactly.
    """
    single = img.ndim == 2
    stack = (img[None] if single else img).to(torch.float32)
    parts = [
        _detect_chunk(stack[i : i + _CHUNK], max_features, num_levels, scale_factor, fast_threshold, grid_cells)
        for i in range(0, stack.shape[0], _CHUNK)
    ]
    out = OrbFeatures(*(torch.cat(p, dim=0) for p in zip(*parts)))
    return OrbFeatures(*(t[0] for t in out)) if single else out
