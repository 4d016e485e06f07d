"""Synthetic turntable-scene renderer with exact ground truth (the port's
copy of ``meatmodeler_tpu/io/synthetic.py``).

The integration-test and smoke-run workload: a food item rotating past a
calibration chessboard, rendered analytically — a tiny vectorized ray
tracer over a plane-bound chessboard and a textured ellipsoid "food item" —
so every run has exact ground truth: K, per-frame poses, board corner
pixels, and the object's true volume (4/3 pi abc).

Rays are cast per pixel; the chessboard quad lives in the X-Z plane (y = 0)
with the reference's layout (``processor.py:162-166``, (4, 3) inner
corners, side length 2), the ellipsoid floats above it. The numpy scene
code (``TurntableScene``, ``camera_pose``, ``_render_frame``, ...) is the
JAX package's, line for line, so ``backend="numpy"`` renders the same
frames from the same seed. ``backend="torch"`` is the same ray tracer
batched on a device (the JAX package's ``_render_frames_jax`` written in
PyTorch), so the 300-frame 1080p headline clip renders on the card in
seconds. Ground-truth rotation vectors come from this package's
``so3.log``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from meatmodeler_tpu_torch.geometry import so3

__all__ = ["TurntableScene", "camera_pose", "render_sequence", "degrade_sequence"]


def _speckle(px, py, pz, m):
    """Aperiodic surface speckle at world point (px, py, pz); ``m`` is the
    array module (numpy or torch — the two renderers must match).

    Five incommensurate 3D-coupled sinusoids: a texture with a single
    low-frequency period (the original ``sin(7x)cos(6z)``) is a barber pole
    — surface points one period apart are visually IDENTICAL, descriptor
    matching locks onto the moving phase instead of the moving surface
    (measured: matched flow dx ~2.7 px where the true surface flow is
    6.3 px), and no robust estimator can recover pose from consistently
    aliased correspondences. Incommensurate frequencies make every patch on
    the object unique at ORB-patch scale, like real-world texture.
    """
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
    """Scene + camera-rig description. Distances in board-square units
    (side_length scales the squares like ``processor.py:434``)."""

    image_size: Tuple[int, int] = (640, 480)  # (W, H)
    pattern: Tuple[int, int] = (4, 3)  # inner corners
    side_length: float = 2.0
    # Ellipsoid semi-axes and center (the "food item" sits beside the board
    # so both stay visible — the reference's scenario has the item rotating
    # past the chessboard, not covering it).
    ellipsoid_axes: Tuple[float, float, float] = (2.0, 1.5, 1.8)
    ellipsoid_center: Tuple[float, float, float] = (11.5, -1.8, 2.0)
    # Camera ring: radius, height (negative y is "up" in OpenCV convention),
    # arc swept over the sequence, look-at target.
    ring_radius: float = 18.0
    ring_height: float = -8.5
    arc_degrees: float = 50.0
    focal: float = 700.0
    noise_sigma: float = 1.5
    # False renders the ground plane as a uniform white sheet (no checker
    # squares): the marker-free test scene, where the only trackable
    # structure is the ellipsoid's speckle texture.
    show_board: bool = True
    # Amplitude (grey levels) of a weak aperiodic speckle on the ground
    # sheet's white areas. 0 = perfectly uniform sheet. A compact textured
    # object over a FEATURELESS ground is gauge-ambiguous for monocular SfM
    # (the bas-relief family: measured on the 24-frame marker-free clip, a
    # pose 27 deg off reprojects every observation at 0.58 px, tying the
    # truth at 0.53 — no estimator can separate them from image evidence).
    # Real tabletop scenes have surface grain; a few grey levels of it puts
    # background parallax in view and makes the scene well-posed, so the
    # marker-free accuracy gates use ground_texture > 0.
    ground_texture: float = 0.0

    @property
    def intrinsics(self) -> np.ndarray:
        w, h = self.image_size
        return np.array(
            [[self.focal, 0.0, w / 2.0], [0.0, self.focal, h / 2.0], [0.0, 0.0, 1.0]]
        )

    @property
    def volume(self) -> float:
        a, b, c = self.ellipsoid_axes
        return 4.0 / 3.0 * np.pi * a * b * c

    def board_corners_3d(self) -> np.ndarray:
        """(N, 3) inner-corner world points, X-Z plane, y = 0 — the layout of
        ``poseEstimation`` (``processor.py:162-166``)."""
        x, y = self.pattern
        grid = np.mgrid[0:x, 0:y].T.reshape(-1, 2) * self.side_length
        pts = np.zeros((x * y, 3), np.float64)
        pts[:, 0] = grid[:, 0]
        pts[:, 2] = grid[:, 1]
        return pts


def camera_pose(scene: TurntableScene, t: float) -> Tuple[np.ndarray, np.ndarray]:
    """World->camera (R, tvec) for normalized time t in [0, 1] along the arc,
    looking at the scene center."""
    ang = np.deg2rad(scene.arc_degrees) * (t - 0.5)
    # Aim between the board center and the item so both stay in frame.
    x, y = scene.pattern
    board_center = np.array(
        [(x - 1) * scene.side_length / 2.0, 0.0, (y - 1) * scene.side_length / 2.0]
    )
    target = 0.5 * (board_center + np.array(scene.ellipsoid_center))
    center = target + np.array(
        [scene.ring_radius * np.sin(ang), scene.ring_height, -scene.ring_radius * np.cos(ang)]
    )

    # Look-at: camera z axis points at the target.
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])  # OpenCV y-down convention; -y is up
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])  # rows: camera axes in world coords
    tvec = -rot @ center
    return rot, tvec


def _checker_color(u: np.ndarray, v: np.ndarray, scene: TurntableScene) -> np.ndarray:
    """Chessboard shading in board-plane coords (world x, z). The (4, 3)
    inner-corner pattern needs a 5x4 field of squares; corners sit on the
    integer grid {0..3} x {0..2} at square boundaries."""
    s = scene.side_length
    # Shift so corner (0,0) is a square intersection: squares span
    # [-1, 4] x [-1, 3] in corner units.
    iu = np.floor(u / s + 1.0)
    iv = np.floor(v / s + 1.0)
    x, y = scene.pattern
    in_board = (u >= -s) & (u <= x * s) & (v >= -s) & (v <= y * s)
    # White border apron around the squares (required by board detectors).
    in_apron = (u >= -2.2 * s) & (u <= (x + 1.2) * s) & (v >= -2.2 * s) & (v <= (y + 1.2) * s)
    checker = np.where((iu + iv) % 2 == 0, 235.0, 20.0)
    if not scene.show_board:
        checker = np.full_like(checker, 235.0)
    color = np.where(in_board, checker, np.where(in_apron, 235.0, np.nan))
    if scene.ground_texture > 0:
        # Weak sheet grain on the white areas only (dark squares keep their
        # detector contrast). _speckle at plane coords stays aperiodic.
        grain = scene.ground_texture * (_speckle(u, 0.0, v, np) - 150.0) / 110.0
        color = np.where(color > 128, np.clip(color + grain, 0, 255), color)
    return color


def _render_frame(scene: TurntableScene, rot: np.ndarray, tvec: np.ndarray, rng) -> np.ndarray:
    w, h = scene.image_size
    k = scene.intrinsics

    # Rays in world space.
    xs = (np.arange(w) - k[0, 2]) / k[0, 0]
    ys = (np.arange(h) - k[1, 2]) / k[1, 1]
    dirs_cam = np.stack(
        [np.tile(xs, (h, 1)), np.tile(ys[:, None], (1, w)), np.ones((h, w))], axis=-1
    )
    dirs = dirs_cam @ rot  # R^T @ d for each pixel
    origin = -rot.T @ tvec

    img = np.full((h, w), 135.0)  # grey background
    depth = np.full((h, w), np.inf)

    # --- chessboard plane y = 0 ---
    dy = dirs[..., 1]
    tt = np.where(np.abs(dy) > 1e-9, -origin[1] / dy, np.inf)
    hit = tt > 0.1
    pu = origin[0] + tt * dirs[..., 0]
    pv = origin[2] + tt * dirs[..., 2]
    color = _checker_color(pu, pv, scene)
    plane_ok = hit & ~np.isnan(color)
    img = np.where(plane_ok & (tt < depth), color, img)
    depth = np.where(plane_ok, np.minimum(depth, tt), depth)

    # --- ellipsoid ---
    c = np.array(scene.ellipsoid_center)
    ax = np.array(scene.ellipsoid_axes)
    oc = (origin - c) / ax
    d_s = dirs / ax
    a_q = np.sum(d_s * d_s, axis=-1)
    b_q = 2.0 * np.sum(d_s * oc, axis=-1)
    c_q = np.sum(oc * oc) - 1.0
    disc = b_q * b_q - 4 * a_q * c_q
    t_hit = np.where(disc >= 0, (-b_q - np.sqrt(np.maximum(disc, 0))) / (2 * a_q), np.inf)
    ell_ok = (t_hit > 0.1) & (t_hit < depth)

    # Procedural surface texture (trackable speckle) + Lambert shading.
    with np.errstate(invalid="ignore"):
        t_safe = np.where(np.isfinite(t_hit), t_hit, 0.0)
        p_hit = origin + t_safe[..., None] * dirs
        n = (p_hit - c) / (ax * ax)
        n_norm = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        light = np.array([0.4, -0.8, 0.45])
        light = light / np.linalg.norm(light)
        lam = np.clip(np.einsum("...i,i", n_norm, -light), 0.35, 1.0)
        tex = _speckle(p_hit[..., 0], p_hit[..., 1], p_hit[..., 2], np)
        img = np.where(ell_ok, np.clip(tex * lam, 15, 250), img)

    if scene.noise_sigma > 0:
        img = img + rng.normal(scale=scene.noise_sigma, size=img.shape)
    return np.clip(img, 0, 255)


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
      backend: "numpy" (the reference's renderer: the same frames as the
        JAX package's ``render_sequence`` with this seed) or
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


def _tint(grey: np.ndarray) -> np.ndarray:
    """Mild channel tinting so the BGR->LAB->CLAHE path is exercised."""
    return np.stack(
        [
            np.clip(grey * 0.96 + 4, 0, 255),
            np.clip(grey * 1.0, 0, 255),
            np.clip(grey * 1.03, 0, 255),
        ],
        axis=-1,
    ).astype(np.uint8)



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


def degrade_sequence(frames: np.ndarray, kind: str, seed: int = 0, strength: float = 1.0) -> np.ndarray:
    """A capture degradation applied to a rendered uint8 BGR clip after
    rendering, so the ground truth (poses, corners, volume) is unchanged:
    the JAX package's robustness families, from the same numpy draws.

    Kinds: "noise" (additive Gaussian, sigma 8 * strength), "blur"
    (horizontal box motion blur of ~9 * strength px), "flicker" (sinusoidal
    gain, +-25% * strength over the clip), "occlusion" (a grey square of
    ~18% * strength of the short side drifting over the board's region on
    every third frame). "jpeg" (a JPEG round trip) needs cv2, which this
    package does not use: it raises.
    """
    rng = np.random.default_rng(seed)
    out = np.asarray(frames)
    t, h, w = out.shape[:3]
    if kind == "noise":
        noisy = out.astype(np.float32) + rng.normal(0.0, 8.0 * strength, size=out.shape).astype(np.float32)
        return np.clip(noisy, 0, 255).astype(np.uint8)
    if kind == "blur":
        k = max(3, int(round(9 * strength)) | 1)
        # Horizontal box blur by cumulative sums, edge-padded.
        pad = np.pad(out.astype(np.float32), ((0, 0), (0, 0), (k // 2, k // 2), (0, 0)), mode="edge")
        cs = np.cumsum(pad, axis=2)
        blurred = (cs[:, :, k - 1 :] - np.concatenate([np.zeros_like(cs[:, :, :1]), cs[:, :, :-k]], axis=2)) / k
        return np.clip(blurred, 0, 255).astype(np.uint8)
    if kind == "flicker":
        phase = rng.uniform(0, 2 * np.pi)
        gain = 1.0 + 0.25 * strength * np.sin(np.linspace(0, 6 * np.pi, t) + phase)
        return np.clip(out.astype(np.float32) * gain[:, None, None, None], 0, 255).astype(np.uint8)
    if kind == "jpeg":
        raise NotImplementedError(
            "degrade_sequence(kind='jpeg') encodes and decodes JPEG with cv2, which this package does not use"
        )
    if kind == "occlusion":
        occ = out.copy()
        side = int(min(h, w) * 0.18 * strength)
        for i in range(0, t, 3):
            cy = int(h * 0.62 + 0.1 * h * np.sin(i / 7.0))
            cx = int(w * 0.5 + 0.25 * w * np.cos(i / 11.0))
            y0, x0 = max(cy - side // 2, 0), max(cx - side // 2, 0)
            occ[i, y0 : y0 + side, x0 : x0 + side] = 96
        return occ
    raise ValueError(f"unknown degradation kind: {kind!r}")
