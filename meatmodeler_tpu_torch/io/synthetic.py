"""Synthetic turntable renderer for the port (counterpart of
``meatmodeler_tpu/io/synthetic.py::render_sequence``).

Reuses the reference's numpy scene description and ray tracer
(``TurntableScene``, ``camera_pose``, ``_render_frame``, ``_tint``), which
load no JAX, and adds ``backend="torch"``: the reference's batched JAX ray
tracer (``_render_frames_jax``) written in PyTorch, so the 300-frame 1080p
headline clip renders on the card in seconds. Ground-truth rotation vectors
come from this package's ``so3.log``.
"""

from __future__ import annotations

import numpy as np
import torch

from meatmodeler_tpu.io.synthetic import (
    TurntableScene,
    _render_frame,
    _speckle,
    _tint,
    camera_pose,
)
from meatmodeler_tpu_torch.geometry import so3

__all__ = ["TurntableScene", "render_sequence"]


def render_sequence(
    scene: TurntableScene,
    num_frames: int,
    seed: int = 0,
    color: bool = True,
    backend: str = "numpy",
    device="cpu",
):
    """Render the turntable sequence.

    Args:
      backend: "numpy" (the reference's renderer: the same frames as
        ``meatmodeler_tpu.io.synthetic.render_sequence`` with this seed) or
        "torch" (the same ray tracer batched on ``device``; the noise is
        drawn from a seeded ``torch.Generator``, so it differs from the
        numpy backend's in bits, not in distribution).

    Returns (frames (T, H, W, 3) uint8 BGR — or (T, H, W) grey with
    ``color=False`` — as a numpy array, poses (T, 6) [rvec, tvec], corners
    (T, N, 2) ground-truth inner-corner pixels).
    """
    rng = np.random.default_rng(seed)
    board = scene.board_corners_3d()
    k = scene.intrinsics
    rots, tvecs, poses, corners = [], [], [], []
    for i in range(num_frames):
        rot, tvec = camera_pose(scene, i / max(num_frames - 1, 1))
        rots.append(rot)
        tvecs.append(tvec)
        rvec = so3.log(torch.from_numpy(rot)).numpy()
        poses.append(np.concatenate([rvec, tvec]))
        proj = (k @ ((rot @ board.T).T + tvec).T).T
        corners.append(proj[:, :2] / proj[:, 2:3])

    if backend == "torch":
        frames = _render_frames_torch(scene, np.stack(rots), np.stack(tvecs), seed, color, device)
    elif backend == "numpy":
        frames = np.stack(
            [
                _tint(g) if color else g.astype(np.uint8)
                for g in (_render_frame(scene, r, t, rng) for r, t in zip(rots, tvecs))
            ]
        )
    else:
        raise ValueError(f"backend must be 'numpy' or 'torch', got {backend!r}")
    return frames, np.stack(poses), np.stack(corners)


@torch.no_grad()
def _render_frames_torch(scene, rots, tvecs, seed, color, device, chunk: int = 16) -> np.ndarray:
    """The reference ray tracer, batched over frame chunks on ``device``."""
    device = torch.device(device)
    w, h = scene.image_size
    k = scene.intrinsics
    s = scene.side_length
    px, py = scene.pattern
    f32 = dict(dtype=torch.float32, device=device)
    c = torch.tensor(scene.ellipsoid_center, **f32)
    ax = torch.tensor(scene.ellipsoid_axes, **f32)
    xs = (np.arange(w) - k[0, 2]) / k[0, 0]
    ys = (np.arange(h) - k[1, 2]) / k[1, 1]
    dirs_cam = torch.from_numpy(
        np.stack([np.tile(xs, (h, 1)), np.tile(ys[:, None], (1, w)), np.ones((h, w))], axis=-1).astype(np.float32)
    ).to(device)
    light = np.array([0.4, -0.8, 0.45])
    light = torch.tensor(light / np.linalg.norm(light), **f32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    out = []
    for i in range(0, len(rots), chunk):
        rot = torch.tensor(rots[i : i + chunk], **f32)  # (C, 3, 3)
        tvec = torch.tensor(tvecs[i : i + chunk], **f32)
        dirs = torch.einsum("hwi,cij->chwj", dirs_cam, rot)  # R^T d per pixel
        origin = -torch.einsum("cji,cj->ci", rot, tvec)  # (C, 3)
        o = origin[:, None, None, :]

        img = torch.full(dirs.shape[:3], 135.0, **f32)
        depth = torch.full(dirs.shape[:3], torch.inf, **f32)

        # --- chessboard plane y = 0 ---
        dy = dirs[..., 1]
        tt = torch.where(torch.abs(dy) > 1e-9, -o[..., 1] / dy, torch.full_like(dy, torch.inf))
        hit = tt > 0.1
        pu = o[..., 0] + tt * dirs[..., 0]
        pv = o[..., 2] + tt * dirs[..., 2]
        iu = torch.floor(pu / s + 1.0)
        iv = torch.floor(pv / s + 1.0)
        in_board = (pu >= -s) & (pu <= px * s) & (pv >= -s) & (pv <= py * s)
        in_apron = (pu >= -2.2 * s) & (pu <= (px + 1.2) * s) & (pv >= -2.2 * s) & (pv <= (py + 1.2) * s)
        checker = torch.where(torch.remainder(iu + iv, 2) == 0, 235.0, 20.0)
        if not scene.show_board:
            checker = torch.full_like(checker, 235.0)
        color_v = torch.where(in_board, checker, torch.full_like(checker, 235.0))
        if scene.ground_texture > 0:
            grain = scene.ground_texture * (_speckle(pu, 0.0, pv, torch) - 150.0) / 110.0
            color_v = torch.where(color_v > 128, torch.clamp(color_v + grain, 0, 255), color_v)
        plane_ok = hit & (in_board | in_apron)
        img = torch.where(plane_ok & (tt < depth), color_v, img)
        depth = torch.where(plane_ok, torch.minimum(depth, tt), depth)

        # --- ellipsoid ---
        oc = ((origin - c) / ax)[:, None, None, :]
        d_s = dirs / ax
        a_q = torch.sum(d_s * d_s, dim=-1)
        b_q = 2.0 * torch.sum(d_s * oc, dim=-1)
        c_q = torch.sum(oc * oc, dim=-1) - 1.0
        disc = b_q * b_q - 4 * a_q * c_q
        t_hit = torch.where(
            disc >= 0, (-b_q - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a_q), torch.full_like(disc, torch.inf)
        )
        ell_ok = (t_hit > 0.1) & (t_hit < depth)
        t_safe = torch.where(torch.isfinite(t_hit), t_hit, torch.zeros_like(t_hit))
        p_hit = o + t_safe[..., None] * dirs
        n = (p_hit - c) / (ax * ax)
        n_norm = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
        lam = torch.clamp(torch.einsum("...i,i", n_norm, -light), 0.35, 1.0)
        tex = _speckle(p_hit[..., 0], p_hit[..., 1], p_hit[..., 2], torch)
        img = torch.where(ell_ok, torch.clamp(tex * lam, 15, 250), img)

        if scene.noise_sigma > 0:
            img = img + scene.noise_sigma * torch.randn(img.shape, generator=gen, **f32)
        grey = torch.clamp(img, 0, 255)
        if color:
            frame = torch.stack(
                [torch.clamp(grey * 0.96 + 4, 0, 255), grey, torch.clamp(grey * 1.03, 0, 255)], dim=-1
            )
        else:
            frame = grey
        out.append(frame.to(torch.uint8).cpu().numpy())
    return np.concatenate(out)
