"""The turntable scene and its renderer, frozen for the benchmark.

A copy of the port's ``io/synthetic.py`` (``TurntableScene``,
``camera_pose`` and the torch ray tracer behind
``render_sequence(..., backend="torch")``) as it stood when the benchmark
was defined. The benchmark makes every input with it, so a change to the
program's renderer cannot change what the benchmark measures. The scene
gives exact ground truth: K, the per-frame poses, the board's corner pixels
and the item's analytic volume (4/3 pi abc).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from portbench.frozen import so3

__all__ = ["TurntableScene", "camera_pose", "render_sequence"]


def _speckle(px, py, pz, m):
    """Aperiodic surface speckle at world point (px, py, pz); ``m`` is the
    array module (numpy or torch)."""
    return (
        150.0
        + 30.0 * m.sin(7.13 * px + 3.71 * pz + 0.9)
        + 26.0 * m.cos(11.71 * pz - 2.93 * py + 0.4)
        + 22.0 * m.sin(9.41 * py + 2.17 * px + 2.2)
        + 18.0 * m.sin(15.97 * px - 7.73 * pz + 1.1)
        + 14.0 * m.cos(21.31 * py + 5.09 * pz + 3.0)
    )


@dataclasses.dataclass(frozen=True)
class TurntableScene:
    """Scene and camera rig. Distances in board-square units."""

    image_size: Tuple[int, int] = (640, 480)  # (W, H)
    pattern: Tuple[int, int] = (4, 3)  # inner corners
    side_length: float = 2.0
    ellipsoid_axes: Tuple[float, float, float] = (2.0, 1.5, 1.8)
    ellipsoid_center: Tuple[float, float, float] = (11.5, -1.8, 2.0)
    ring_radius: float = 18.0
    ring_height: float = -8.5
    arc_degrees: float = 50.0
    focal: float = 700.0
    noise_sigma: float = 1.5
    show_board: bool = True
    ground_texture: float = 0.0

    @property
    def intrinsics(self) -> np.ndarray:
        w, h = self.image_size
        return np.array([[self.focal, 0.0, w / 2.0], [0.0, self.focal, h / 2.0], [0.0, 0.0, 1.0]])

    @property
    def volume(self) -> float:
        a, b, c = self.ellipsoid_axes
        return 4.0 / 3.0 * np.pi * a * b * c

    def board_corners_3d(self) -> np.ndarray:
        """(N, 3) inner-corner world points in the X-Z plane (y = 0)."""
        x, y = self.pattern
        grid = np.mgrid[0:x, 0:y].T.reshape(-1, 2) * self.side_length
        pts = np.zeros((x * y, 3), np.float64)
        pts[:, 0] = grid[:, 0]
        pts[:, 2] = grid[:, 1]
        return pts


def camera_pose(scene: TurntableScene, t: float) -> Tuple[np.ndarray, np.ndarray]:
    """World->camera (R, tvec) at normalized time t in [0, 1] along the arc,
    looking between the board centre and the item."""
    ang = np.deg2rad(scene.arc_degrees) * (t - 0.5)
    x, y = scene.pattern
    board_center = np.array([(x - 1) * scene.side_length / 2.0, 0.0, (y - 1) * scene.side_length / 2.0])
    target = 0.5 * (board_center + np.array(scene.ellipsoid_center))
    center = target + np.array([scene.ring_radius * np.sin(ang), scene.ring_height, -scene.ring_radius * np.cos(ang)])
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    tvec = -rot @ center
    return rot, tvec


def render_sequence(scene: TurntableScene, num_frames: int, seed: int = 0, color: bool = True, device="cpu"):
    """Render the turntable clip on ``device`` (noise from a seeded
    ``torch.Generator`` there).

    Returns (frames (T, H, W, 3) uint8 BGR, or (T, H, W) grey with
    ``color=False``, as a numpy array; poses (T, 6) [rvec, tvec]; corners
    (T, N, 2) ground-truth inner-corner pixels)."""
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
    frames = _render_frames(scene, np.stack(rots), np.stack(tvecs), seed, color, device)
    return frames, np.stack(poses), np.stack(corners)


@torch.no_grad()
def _render_frames(scene, rots, tvecs, seed, color, device, chunk: int = 16) -> np.ndarray:
    """The ray tracer, batched over frame chunks on ``device``."""
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
        rot = torch.tensor(rots[i : i + chunk], **f32)
        tvec = torch.tensor(tvecs[i : i + chunk], **f32)
        dirs = torch.einsum("hwi,cij->chwj", dirs_cam, rot)
        origin = -torch.einsum("cji,cj->ci", rot, tvec)
        o = origin[:, None, None, :]

        img = torch.full(dirs.shape[:3], 135.0, **f32)
        depth = torch.full(dirs.shape[:3], torch.inf, **f32)

        # The board plane y = 0.
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

        # The ellipsoid.
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
            frame = torch.stack([torch.clamp(grey * 0.96 + 4, 0, 255), grey, torch.clamp(grey * 1.03, 0, 255)], dim=-1)
        else:
            frame = grey
        out.append(frame.to(torch.uint8).cpu().numpy())
    return np.concatenate(out)
