"""End-to-end SfM + volume pipeline on one CUDA device — the ``process``
entry point (torch twin of ``meatmodeler_tpu/pipeline.py``).

Two pass-1 implementations, chosen by ``config.pass1_backend`` as in the
reference:

  PASS 1, "device" (the reference's default): host BGR->grey decimation,
    one uint8 byte per downscaled pixel uploaded per chunk, CLAHE (the
    hand-written CUDA kernels), then the keyframe scan on the device
    (pyramidal LK + Shi-Tomasi reseeding). Without ``known_corners`` the
    first board is hunted with the device chessboard detector; after the
    pass every keyframe without corners runs through it in one batch, and
    keyframes where it finds no board are dropped.
  PASS 1, "host": the native C++ keyframe scan (``io.native_pass1``, built
    from ``native/pass1.cpp``); the JAX package hunts its first board with
    cv2, so here it needs ``known_corners`` or ``assume_markerless``.
  Both pass 1s run "marker-free" too, without the board gate: bootstrap at
    frame 0 and keep keyframes without corners. That is the path of
    ``assume_markerless``, and of the automatic fallback when the first
    pass finds fewer than 3 board keyframes (``markerless_fallback``).
  PASS 2 (device): the keyframes' enhance — CLAHE on the LAB lightness then
    grey (``pass2_enhance="bgr_lab"``) or CLAHE on grey ("grey") — ORB,
    Hamming matching, the SoA track store.
  GEOMETRY (device): sub-pixel corners, Zhang calibration, planar PnP,
    pose-only BA — or, marker-free, an assumed K and the keyframe pose
    chain (LO-RANSAC bootstrap, PnP, in-chain BA; up to scale) — then
    triangulation + outlier gate, global Schur BA (or incremental prefix
    solves), hull + carve volume; then the PLY file.

Not part of this package, and raising rather than running something else:
the cv2 board detectors (``detector="host"``/``"auto"`` without
``known_corners``, and the host pass 1's board hunt). The reference's
shape padding and bucketing, compile warm-up threads, pass-2 prefetch and
resolver threads exist only for the XLA compiler and its link, and have no
counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from meatmodeler_tpu_torch import tracks as tracks_mod
from meatmodeler_tpu_torch import volume as volume_mod
from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig, SolverConfig
from meatmodeler_tpu_torch.geometry import calibration, distortion, pnp, projection, ransac, so3, triangulation
from meatmodeler_tpu_torch.io import native_ops
from meatmodeler_tpu_torch.io import ply as ply_mod
from meatmodeler_tpu_torch.io import video as video_mod
from meatmodeler_tpu_torch.io.native_pass1 import HostPass1Scanner
from meatmodeler_tpu_torch.ops import board_detect, chessboard, clahe, features, klt, matching, orb
from meatmodeler_tpu_torch.solvers import bundle_adjust
from meatmodeler_tpu_torch.utils import Metrics, numerics
from meatmodeler_tpu_torch.utils.checkpoint import StageCheckpointer

__all__ = ["ProcessResult", "process"]


class ProcessResult(NamedTuple):
    points: np.ndarray  # (P, 3) bundle-adjusted cloud
    extrinsics: np.ndarray  # (F, 4, 4) refined keyframe extrinsics
    intrinsics: np.ndarray  # (3, 3)
    distortion: np.ndarray  # (5,)
    volume: float  # convex-hull volume of the item
    volume_carved: float  # voxel-carved volume
    ply_path: Optional[str]
    reprojection_rmse: float
    metrics: Dict[str, Any]
    # {"low_confidence", "view_arc_deg", "elongation", "reason", "n_item_points"}
    volume_confidence: Optional[Dict[str, Any]] = None


class PreBA(NamedTuple):
    """Everything computed before the global bundle adjustment."""

    ext_refined: torch.Tensor  # (F, 3, 4) pose-BA-refined extrinsics
    intrinsics: torch.Tensor  # (3, 3)
    dist: torch.Tensor  # (5,)
    points: torch.Tensor  # (P, 3) triangulated inlier points
    obs: torch.Tensor  # (O, 2) undistorted observations
    fidx: torch.Tensor  # (O,) frame indices
    pidx: torch.Tensor  # (O,) point indices
    obs_weight: torch.Tensor  # (O,) inverse-octave-sigma BA weights
    point_sigma: torch.Tensor  # (P,) per-point octave sigma
    point_parallax: torch.Tensor  # (P,) endpoint-ray parallax (deg)
    image_size: Tuple[int, int]  # (w, h) in pass-2 working resolution
    kf_scale: int = 1
    # Marker-free reconstruction (assumed K, up to scale; no board plane).
    markerless: bool = False


def _check_supported(config: PipelineConfig, known_corners) -> None:
    if known_corners is not None or config.assume_markerless:
        return
    if config.pass1_backend == "host":
        raise NotImplementedError(
            "pass1_backend='host' hunts the first board with cv2, which this package "
            "does not use: pass known_corners, set assume_markerless, or use "
            "pass1_backend='device' with chessboard.detector='device'"
        )
    if config.chessboard.detector != "device":
        raise NotImplementedError(
            f"chessboard.detector={config.chessboard.detector!r} detects boards with cv2, "
            "which this package does not use: set chessboard.detector='device' or pass "
            "known_corners"
        )


@contextlib.contextmanager
def full_fp32():
    """Full float32 inside the block: cuDNN would run the Sobel/box/Gaussian
    convolutions, and cuBLAS the matmuls, in TF32 by default (the reference
    pins HIGHEST precision for the same reason). The caller's settings come
    back afterwards, also when the block raises."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _make_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"process(device={str(device)!r}): CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# --------------------------------------------------------------------------
# PASS 1, device: the keyframe scan
# --------------------------------------------------------------------------


def _make_keyframe_scan(config: PipelineConfig):
    """(init_carry, scan_chunk) for the device keyframe scan — the
    reference's ``_make_keyframe_scan``.

    The carry is (previous pyramid, points (K, 2), mask (K,), accumulated
    error, accumulated displacement). The reference reseeds under
    ``lax.cond(is_kf)``; here the reseed candidates of every frame of the
    chunk come from one batched ``good_features`` call before the frame
    loop and ``torch.where`` picks them on keyframes, so the loop never
    reads a flag back to the host. Pyramids are built for the whole chunk
    at once as well; each frame is independent of the scan state there.
    """
    kf = config.keyframe

    def seed_points(greys):
        c = features.good_features(
            greys, max_corners=kf.max_corners, quality_level=kf.quality_level,
            min_distance=kf.min_distance, block_size=kf.block_size,
        )
        return c.xy, c.mask

    def init_carry(grey):
        pts, mask = seed_points(grey)
        zero = torch.zeros((), dtype=torch.float32, device=grey.device)
        return (klt.build_pyramid(grey, kf.pyramid_levels), pts, mask, zero, zero)

    def scan_chunk(carry, greys, width_scale=1):
        # The keyframe rule compares an intensity residual against
        # threshold * FULL-resolution width (or the constant threshold_abs).
        width = greys.shape[2] * width_scale
        thresh = kf.threshold_abs if kf.threshold_abs > 0 else kf.threshold * width
        pyrs = klt.build_pyramid(greys, kf.pyramid_levels)
        seed_xy, seed_mask = seed_points(greys)
        prev_pyr, pts, mask, acc, acc_flow = carry
        flags = []
        for t in range(greys.shape[0]):
            cur_pyr = [p[t] for p in pyrs]
            flow = klt.lucas_kanade(
                prev_pyr, cur_pyr, pts, win=kf.window, levels=kf.pyramid_levels,
                max_iters=kf.max_iters, eps=kf.eps, point_mask=mask,
            )
            # The reference's error accumulation: NaN -> 0, negatives -> 0,
            # then the mean over the live points.
            err = torch.clamp(torch.nan_to_num(flow.error), min=0.0)
            zeros = torch.zeros_like(err)
            acc = acc + torch.sum(torch.where(mask, err, zeros)) / torch.clamp(mask.sum(), min=1)
            # Secondary trigger: accumulated mean tracked displacement.
            ok_flow = mask & flow.status
            disp = torch.nan_to_num(torch.linalg.norm(flow.points - pts, dim=-1))
            acc_flow = acc_flow + torch.sum(torch.where(ok_flow, disp, zeros)) / torch.clamp(ok_flow.sum(), min=1)
            is_kf = acc > thresh
            if kf.flow_threshold > 0:
                is_kf = is_kf | (acc_flow > kf.flow_threshold * greys.shape[2])
            # On a keyframe: reset the sums and reseed at this frame.
            pts = torch.where(is_kf, seed_xy[t], flow.points)
            mask = torch.where(is_kf, seed_mask[t], mask & flow.status)
            acc = torch.where(is_kf, torch.zeros_like(acc), acc)
            acc_flow = torch.where(is_kf, torch.zeros_like(acc_flow), acc_flow)
            prev_pyr = cur_pyr
            flags.append(is_kf)
        return (prev_pyr, pts, mask, acc, acc_flow), torch.stack(flags)

    return init_carry, scan_chunk


# --------------------------------------------------------------------------
# Board detection glue
# --------------------------------------------------------------------------


def _board_fit_residual(corners: np.ndarray, pattern) -> float:
    """Max residual (px) of a planar-homography fit of the board grid: a
    corner snapped to a neighbouring saddle shows as a multi-pixel outlier."""
    cols, rows = pattern
    gx, gy = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    obj = np.stack([gx.ravel(), gy.ravel()], axis=1)
    img = np.asarray(corners, np.float64)
    n = len(obj)
    a = np.zeros((2 * n, 9))
    a[0::2, 0:2] = obj
    a[0::2, 2] = 1.0
    a[0::2, 6:8] = -obj * img[:, :1]
    a[0::2, 8] = -img[:, 0]
    a[1::2, 3:5] = obj
    a[1::2, 5] = 1.0
    a[1::2, 6:8] = -obj * img[:, 1:2]
    a[1::2, 8] = -img[:, 1]
    h = np.linalg.svd(a)[2][-1].reshape(3, 3)
    den = obj @ h[2, :2] + h[2, 2]
    proj = (obj @ h[:2, :2].T + h[:2, 2]) / den[:, None]
    return float(np.abs(proj - img).max())


class _BoardProbe:
    """Budget of the first-board hunt over board-free leading frames. Armed
    only with the marker-free fallback on (and not in a marker-free pass 1,
    which hunts no board): after
    ``config.board_probe_frames`` misses pass 1 stops and returns empty."""

    def __init__(self, config: PipelineConfig, armed: bool):
        self.enabled = armed and config.markerless_fallback and config.board_probe_frames > 0
        self.budget = config.board_probe_frames
        self.probed = 0

    @property
    def exhausted(self) -> bool:
        return self.enabled and self.probed >= self.budget

    def note_miss(self) -> None:
        self.probed += 1


def _detect_board_device_batch(smalls, pattern, scale, cb_cfg):
    """The device detector over a stack of pass-1 greys, with ONE readback
    for the whole stack. Returns canonicalized full-resolution corners, or
    None where no board was found or the planar-fit gate rejects it."""
    det = board_detect.find_chessboard_device(
        smalls, pattern=tuple(pattern), max_candidates=cb_cfg.detect_candidates, tol=cb_cfg.detect_tol,
    )
    fused = torch.cat([det.ok.to(torch.float32)[:, None], det.corners.reshape(det.corners.shape[0], -1)], dim=1)
    out = []
    for row in fused.cpu().numpy():
        if not row[0] > 0.5:
            out.append(None)
            continue
        c = chessboard.canonicalize_corners(row[1:].reshape(-1, 2) * scale, pattern)
        out.append(None if _board_fit_residual(c, pattern) > 3.0 * scale else c)
    return out


def _resolve_board_corners(kf_frames, kf_corners, kf_small, kf_indices, pattern, scale, cb_cfg):
    """Post-pass board detection + sequential orientation anchoring.

    Keyframes without corners go through the device detector as one batch;
    those where it finds no board are dropped (processor.py:369-371). All
    corners then get the 180-degree anchoring against the previous kept
    keyframe. Returns (kept frames, kept corners, kept frame indices).
    """
    pending = [i for i, c in enumerate(kf_corners) if c is None]
    found = {}
    if pending:
        stack = torch.stack([kf_small[i] for i in pending])
        found = dict(zip(pending, _detect_board_device_batch(stack, pattern, scale, cb_cfg)))
    out_frames, out_corners, out_indices = [], [], []
    prev = None
    for i, c in enumerate(kf_corners):
        if c is None:
            c = found[i]
        if c is None:
            continue
        prev = chessboard.orient_corners_to(c, prev)
        out_frames.append(kf_frames[i])
        out_corners.append(prev)
        out_indices.append(kf_indices[i])
    return out_frames, out_corners, out_indices


# --------------------------------------------------------------------------
# PASS 1
# --------------------------------------------------------------------------


def _auto_scales(chunk, scale, p2s):
    """Resolve the "auto" (0) pass-1 and pass-2 downscales on the first chunk."""
    min_dim = min(chunk.shape[1], chunk.shape[2])
    if scale == 0:
        scale = 4 if min_dim >= 1060 else 2 if min_dim >= 720 else 1
    if p2s == 0:
        p2s = 2 if min_dim >= 1060 else 1
    return scale, p2s


def _known_board(known_corners, global_idx, pattern):
    """The caller's board corners of one frame, canonicalized."""
    return chessboard.canonicalize_corners(np.asarray(known_corners[global_idx], np.float32), pattern)


def _keyframe_at_p2s(frame_bgr, config, p2s):
    """A keyframe as pass 2 takes it: grey at 1/p2s (native decimation) for
    ``pass2_enhance="grey"``, else BGR strided to 1/p2s."""
    frame_bgr = np.asarray(frame_bgr)
    if config.pass2_enhance == "grey":
        return native_ops.bgr_to_grey_down(frame_bgr[None], p2s)[0]
    oh, ow = frame_bgr.shape[0] // p2s, frame_bgr.shape[1] // p2s
    return np.ascontiguousarray(frame_bgr[: oh * p2s : p2s, : ow * p2s : p2s])


def _run_pass1(video, config, pattern, known_corners, metrics, device, markerfree=False):
    """The reference's device pass 1 (``_run_pass1``), without its
    resolver thread, pass-2 prefetch and warm-up threads.

    Per chunk: native BGR->grey decimation by ``pass1_downscale``, upload,
    CLAHE, the keyframe scan, one flag readback. Until the scan has started
    the chunk is hunted for the first board: frame 0 with
    ``known_corners`` or ``markerfree`` (no board gate: keyframes keep
    ``None`` corners), else the first frame where the device detector finds
    one (``_BoardProbe`` bounds the hunt). Keyframes stay on the host at
    the pass-2 resolution, with their device CLAHE'd small grey for the
    post-pass detection.

    Returns (kf_frames, kf_corners (known/bootstrap corners, else None),
    kf_small, kf_indices, frames_total, pass-1 scale, pass-2 scale).
    """
    import time as _time

    init_carry, scan_chunk = _make_keyframe_scan(config)
    source = video_mod.FrameSource(video)
    scale, p2s = config.pass1_downscale, config.pass2_downscale
    with metrics.stage("pass1_keyframes"):
        carry = None
        frame_idx = 0
        kf_frames, kf_corners, kf_small, kf_indices = [], [], [], []
        probe = _BoardProbe(config, armed=not markerfree and known_corners is None)

        def retain(frame_bgr, small, corners, global_idx):
            kf_frames.append(_keyframe_at_p2s(frame_bgr, config, p2s))
            kf_corners.append(corners)
            kf_small.append(small)
            kf_indices.append(int(global_idx))

        for chunk in source.chunks(config.frame_chunk):
            scale, p2s = _auto_scales(chunk, scale, p2s)
            n = len(chunk)
            t0 = _time.perf_counter()
            grey_host = native_ops.bgr_to_grey_down(chunk, scale)
            t1 = _time.perf_counter()
            greys = clahe.clahe(torch.from_numpy(grey_host).to(device).to(torch.float32))
            metrics.add("pass1_decim_s", t1 - t0)
            metrics.add("pass1_upload_s", _time.perf_counter() - t1)

            idx0 = frame_idx
            frame_idx += n
            offset = 0
            if carry is None:
                # Discard leading frames until the board is visible
                # (processor.py:315-319), within the probe's budget.
                start = None
                if markerfree or known_corners is not None:
                    start = 0
                    c0 = _known_board(known_corners, idx0, pattern) if known_corners is not None else None
                    retain(chunk[0], greys[0], c0, idx0)
                else:
                    for i, c0 in enumerate(_detect_board_device_batch(greys, pattern, scale, config.chessboard)):
                        if c0 is not None:
                            start = i
                            retain(chunk[i], greys[i], c0, idx0 + i)
                            break
                        probe.note_miss()
                if start is None:
                    if probe.exhausted:
                        metrics.count("board_probe_exhausted", probe.probed)
                        break
                    continue
                carry = init_carry(greys[start])
                offset = start + 1
                if offset >= n:
                    continue

            t0 = _time.perf_counter()
            # As in the reference, the scan runs over the whole chunk, the
            # bootstrap frame and those before it included; their flags are
            # dropped.
            carry, flags_dev = scan_chunk(carry, greys, width_scale=scale)
            t1 = _time.perf_counter()
            flags = flags_dev.cpu().numpy()
            flags[:offset] = False
            metrics.add("pass1_scan_dispatch_s", t1 - t0)
            metrics.add("pass1_sync_s", _time.perf_counter() - t1)
            for i in np.nonzero(flags)[0]:
                c = _known_board(known_corners, idx0 + int(i), pattern) if known_corners is not None else None
                retain(chunk[i], greys[i], c, idx0 + int(i))

        metrics.count("frames_total", frame_idx)
        metrics.count("keyframes_selected", len(kf_frames))
    return kf_frames, kf_corners, kf_small, kf_indices, frame_idx, scale, p2s or 1


def _run_pass1_host(video, config, pattern, known_corners, metrics, device, markerfree=False):
    """The reference's ``_run_pass1_host`` with known corners or
    ``markerfree``: the native C++ scan bootstraps at frame 0 and flags
    keyframes; each keyframe is kept on the host at the pass-2 working
    resolution, with its known corners (``None`` when marker-free). Same
    return tuple as :func:`_run_pass1` (no small greys: no keyframe goes
    through the board detector)."""
    import time as _time

    source = video_mod.FrameSource(video)
    scale, p2s = config.pass1_downscale, config.pass2_downscale
    with metrics.stage("pass1_keyframes"):
        frame_idx = 0
        kf_frames, kf_corners, kf_indices = [], [], []
        scanner = None

        def retain(frame_bgr, global_idx):
            kf_frames.append(_keyframe_at_p2s(frame_bgr, config, p2s))
            kf_corners.append(None if markerfree else _known_board(known_corners, global_idx, pattern))
            kf_indices.append(int(global_idx))

        for chunk in source.chunks(config.frame_chunk):
            scale, p2s = _auto_scales(chunk, scale, p2s)
            t_d0 = _time.perf_counter()
            grey_host = native_ops.bgr_to_grey_down(chunk, scale)
            metrics.add("pass1_decim_s", _time.perf_counter() - t_d0)
            if scanner is None:
                scanner = HostPass1Scanner(
                    config, grey_host.shape[1], grey_host.shape[2], full_width=chunk.shape[2]
                )
            idx0 = frame_idx
            frame_idx += len(chunk)
            bootstrap_at = 0 if not scanner.initialized else -1
            t_s0 = _time.perf_counter()
            flags, _ = scanner.scan(grey_host, bootstrap_at=bootstrap_at)
            metrics.add("pass1_host_scan_s", _time.perf_counter() - t_s0)
            if bootstrap_at >= 0:
                # The bootstrap frame is always a keyframe.
                retain(chunk[0], idx0)
                flags[:1] = False
            for i in np.nonzero(flags)[0]:
                retain(chunk[i], idx0 + int(i))

        metrics.count("frames_total", frame_idx)
        metrics.count("keyframes_selected", len(kf_frames))
    return kf_frames, kf_corners, [], kf_indices, frame_idx, scale, p2s or 1


# --------------------------------------------------------------------------
# PASS 2 + geometry
# --------------------------------------------------------------------------


def _pose_stage(corners, intr, dist_coefs, obj_z0, side_length):
    """Undistort the corners and solve planar PnP against the reference's
    X-Z board (``processor.py:162-166``)."""
    und_corners = distortion.undistort_pixels(corners, intr, dist_coefs)
    board_xz = torch.zeros((obj_z0.shape[0], 3), dtype=corners.dtype, device=corners.device)
    board_xz[:, 0] = obj_z0[:, 0] * side_length
    board_xz[:, 2] = obj_z0[:, 1] * side_length
    poses = pnp.solve_pnp_batch(board_xz[:, [0, 2]], (0, 2), board_xz, und_corners, intr)
    return und_corners, poses


def _triangulate_gate(store, ext_refined, intr, dist_coefs, tri_mode, scale_factor, min_parallax_deg, reproj_gate):
    """Triangulate every track and gate outliers by their worst
    octave-normalized reprojection residual and the endpoint parallax
    (the reference's ``_make_triangulate_gate``)."""
    coords_und = distortion.undistort_pixels(store.coords, intr, dist_coefs)
    store = store._replace(coords=coords_und)
    projections = projection.projection_from_extrinsic(intr, ext_refined)
    first_kf, last_kf, first_xy, last_xy, tri_valid = tracks_mod.triangulation_endpoints(store)
    if tri_mode == "nview":
        pts3d = triangulation.triangulate_nview(projections, store.coords, store.obs_mask)
    else:
        pts3d = triangulation.triangulate_pairs(projections[first_kf], projections[last_kf], first_xy, last_xy)
    finite = torch.all(torch.isfinite(pts3d), dim=1)
    cam_params = projection.params_from_extrinsics(ext_refined)
    proj_all = projection.project_points(pts3d[:, None, :], cam_params[None, :, :], intr)  # (T, F, 2)
    resid = torch.linalg.norm(proj_all - store.coords, dim=-1)
    sigma_obs = torch.tensor(scale_factor, dtype=torch.float32, device=intr.device) ** store.octaves.to(torch.float32)
    resid_norm = torch.where(store.obs_mask, resid / sigma_obs, torch.zeros_like(resid))
    inlier = torch.amax(resid_norm, dim=1) < reproj_gate
    rot = ext_refined[:, :3, :3]
    centers = -torch.einsum("fij,fi->fj", rot, ext_refined[:, :3, 3])
    r1 = pts3d - centers[first_kf]
    r2 = pts3d - centers[last_kf]
    cosang = torch.sum(r1 * r2, dim=1) / torch.clamp(
        torch.linalg.norm(r1, dim=1) * torch.linalg.norm(r2, dim=1), min=1e-12
    )
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    if min_parallax_deg > 0:
        inlier &= parallax_deg > min_parallax_deg
    store = store._replace(points=torch.where(finite[:, None], pts3d, torch.zeros_like(pts3d)))
    return store, tri_valid & finite & inlier, torch.sum(finite & ~inlier), parallax_deg


# --------------------------------------------------------------------------
# Marker-free pose bootstrap
# --------------------------------------------------------------------------


def _make_markerfree_stages(reproj_gate: float):
    """(triangulate_known, pnp_support): masked n-view re-triangulation with
    its validity gates, and reprojection support counting. Keyframes not yet
    posed hold placeholder poses; masking their observations keeps them
    inert."""

    def triangulate_known(params, known_mask, coords, obs_mask, intr):
        m = obs_mask & known_mask[None, :]
        exts = projection.extrinsics_from_params(params)
        pts3d = triangulation.triangulate_nview(projection.projection_from_extrinsic(intr, exts), coords, m)
        finite = torch.all(torch.isfinite(pts3d), dim=1)
        proj_all = projection.project_points(pts3d[:, None, :], params[None, :, :], intr)  # (T, F, 2)
        resid = torch.linalg.norm(proj_all - coords, dim=-1)
        resid_ok = torch.where(m, resid, torch.zeros_like(resid))
        # Positive depth in every keyframe that observed the track.
        cam_z = torch.einsum("fj,tj->tf", exts[:, 2, :3], pts3d) + exts[None, :, 2, 3]
        in_front = torch.all(torch.where(m, cam_z > 1e-3, torch.ones_like(m)), dim=1)
        valid = finite & in_front & (m.sum(1) >= 2) & (torch.amax(resid_ok, dim=1) < reproj_gate)
        return torch.where(finite[:, None], pts3d, torch.zeros_like(pts3d)), valid

    def pnp_support(poses, pts3d, xy, m, intr):
        """(C,) candidate poses -> (C, T) tracks reprojecting within 2 gates."""
        proj = projection.project_points(pts3d[None], poses[:, None, :], intr)
        return m & (torch.linalg.norm(proj - xy, dim=-1) < 2.0 * reproj_gate)

    return triangulate_known, pnp_support


def _make_chain_step(reproj_gate: float, pose_cfg, chain_cfg):
    """One incremental-chain step: masked re-triangulation -> 2-start PnP
    -> outlier-trimmed re-solve -> masked warm-started BA over the keyframes
    posed so far. The PnP winner is picked on the device; whether the
    trimmed re-solve applies is the step's one host read (the reference
    computes it always and selects by predicate: the same result)."""
    triangulate_known, pnp_support = _make_markerfree_stages(reproj_gate)

    def chain_step(params, known, lam, i, coords, obs_mask, obs_all, fidx_all, pidx_all, intr):
        pts3d, valid3d = triangulate_known(params, known, coords, obs_mask, intr)
        m = valid3d & obs_mask[:, i]
        xy = coords[:, i]

        # Constant-velocity SE(3) extrapolation E_pred = (E_{i-1} E_{i-2}^-1) E_{i-1}.
        e1, e2 = projection.extrinsics_from_params(params[[i - 1, i - 2]], homogeneous=True)
        e2inv = torch.eye(4, dtype=e2.dtype, device=e2.device)
        e2inv[:3, :3] = e2[:3, :3].T
        e2inv[:3, 3] = -e2[:3, :3].T @ e2[:3, 3]
        e_pred = (e1 @ e2inv) @ e1
        p_pred = torch.cat([so3.log(e_pred[:3, :3]), e_pred[:3, 3]])

        # PnP from two starts, the previous pose and the extrapolation: the
        # former alone biases LM toward a rotation-dominant basin on
        # turntable motion. Both ride one batched solve.
        starts = torch.stack([params[i - 1], p_pred])
        cands = bundle_adjust.pose_only_refine(
            starts, pts3d.expand(2, -1, -1), intr, xy.expand(2, -1, -1), m.expand(2, -1), config=pose_cfg
        )
        inl2 = pnp_support(cands, pts3d, xy, m, intr)
        counts = inl2.sum(1)
        best = torch.argmax(counts)
        refined, inl = cands[best], inl2[best]
        n_m, n_inl = m.sum(), counts[best]
        if bool((n_inl >= 6) & (n_inl < n_m)):  # outlier-trimmed re-solve
            refined = bundle_adjust.pose_only_refine(
                refined[None], pts3d[None], intr, xy[None], inl[None], config=pose_cfg
            )[0]
        params = params.clone()
        params[i] = refined
        known = known.clone()
        known[i] = True

        # In-chain BA over keyframes 0..i, warm-started from the previous
        # step's exit damping.
        pts3d, valid3d = triangulate_known(params, known, coords, obs_mask, intr)
        _, ext4, ba_res = bundle_adjust.adjust_points(
            projection.extrinsics_from_params(params), intr, pts3d, obs_all, fidx_all, pidx_all,
            mask=known[fidx_all], weights=valid3d[pidx_all].to(torch.float32),
            config=chain_cfg, init_lambda=lam,
        )
        params = projection.params_from_extrinsics(ext4[:, :3, :])
        lam = torch.clamp(ba_res.final_lambda * chain_cfg.lambda_down, max=chain_cfg.init_lambda)
        return params, known, lam, n_m, n_inl

    return chain_step


def _chain_keyframe_poses(store, intrinsics, n_kf, reproj_gate: float = 4.0):
    """Marker-free keyframe poses: essential bootstrap + PnP + in-chain BA
    (the reference's ``_chain_keyframe_poses``).

    The first keyframe pair is posed by the batched LO-RANSAC estimator
    (``geometry/ransac.py``); its unit baseline sets the monocular gauge.
    Every later keyframe is posed by PnP (a 2-start pose-only LM against
    the tracks triangulated so far), and each addition is followed by a
    masked, warm-started BA over everything posed so far: on a compact
    scene pure PnP chaining would compound a slightly-off bootstrap into
    every later pose. World frame = keyframe 0's camera, re-anchored after
    the last step. The "< 6 visible tracks" gates are read in one fetch
    after the loop, so a doomed video fails with the reference's error.

    Returns ((F, 3, 4) extrinsics, per-step support counts: epipolar
    inliers of the bootstrap pair, PnP inlier counts after).
    """
    k = intrinsics.to(torch.float32)
    coords, obs_mask = store.coords, store.obs_mask
    # Every observed (track, keyframe) cell, built once: keyframes not yet
    # posed enter the in-chain BA masked.
    pidx_all, fidx_all = torch.nonzero(obs_mask, as_tuple=True)
    obs_all = coords[pidx_all, fidx_all]

    sel01 = obs_mask[:, 0] & obs_mask[:, 1]
    rvec, tvec, res = ransac.estimate_relative_pose(coords[:, 0], coords[:, 1], sel01, k)
    n_inl = int((res.inliers & sel01).sum())
    support = [n_inl]
    if n_inl < 8:
        raise ValueError(
            f"marker-free pose bootstrap failed: keyframe pair (0, 1) has "
            f"only {n_inl} epipolar inliers (< 8) — the video lacks "
            "trackable structure or camera motion"
        )

    params = torch.zeros((coords.shape[1], 6), dtype=torch.float32, device=k.device)
    params[1] = torch.cat([rvec, tvec])
    # Placeholder for keyframes not yet posed: the last known pose.
    params[2:] = params[1]
    known = torch.zeros(coords.shape[1], dtype=torch.bool, device=k.device)
    known[:2] = True

    pose_cfg = dataclasses.replace(SolverConfig(), ftol=1e-8, max_iters=100)
    # In-chain BA: a short budget per step (warm-started).
    chain_cfg = dataclasses.replace(SolverConfig(), ftol=1e-6, max_iters=12)
    chain_step = _make_chain_step(float(reproj_gate), pose_cfg, chain_cfg)
    lam = torch.tensor(chain_cfg.init_lambda, dtype=torch.float32, device=k.device)
    gates = []
    for i in range(2, n_kf):
        params, known, lam, n_m, n_inl_i = chain_step(
            params, known, lam, i, coords, obs_mask, obs_all, fidx_all, pidx_all, k
        )
        gates.append(torch.stack([n_m, n_inl_i]))
    if gates:
        for step_off, (n_m_v, n_inl_v) in enumerate(torch.stack(gates).cpu().tolist()):
            if n_m_v < 6:
                raise ValueError(
                    f"marker-free PnP chaining failed at keyframe {step_off + 2}: "
                    f"only {n_m_v} triangulated tracks visible (< 6) — the "
                    "video lacks persistent trackable structure across keyframes"
                )
            support.append(max(n_inl_v, 0))

    # Re-anchor the gauge to keyframe 0: ext_i' = ext_i o ext_0^-1.
    exts = projection.extrinsics_from_params(params[:n_kf])
    r0, t0 = exts[0, :3, :3], exts[0, :3, 3]
    r_new = exts[:, :3, :3] @ r0.T
    t_new = exts[:, :3, 3] - torch.einsum("fij,j->fi", r_new, t0)
    return torch.cat([r_new, t_new[:, :, None]], dim=2), support


def _pass2_to_preba(config, metrics, ckpt, kf_stack, kf_frames, kf_corners, kf_indices, frame_idx, p2s, markerless, device):
    """PASS 2 + geometry from the keyframes to the BA-ready problem.
    ``kf_stack`` (enhanced greys, from a checkpoint) or ``kf_frames`` (raw
    host keyframes to upload and enhance here) must be given. ``markerless``:
    the keyframes carry no corners; K is assumed and the poses come from the
    marker-free chain."""
    n_kf = len(kf_corners)
    if kf_stack is None:
        with metrics.stage("pass2_preprocess"):
            frames = torch.from_numpy(np.stack(kf_frames)).to(device)
            # The reference's pass-2 enhances use CLAHE's defaults: grey
            # keyframes get CLAHE, BGR ones ``bgr_lab`` (CLAHE on L, grey).
            if frames.ndim == 3:
                kf_stack = clahe.clahe(frames.to(torch.float32))
            else:
                kf_stack = clahe.enhanced_grey(frames)
    if ckpt.enabled and not ckpt.has("keyframes"):
        ckpt.save(
            "keyframes",
            greys=kf_stack.cpu().numpy(),
            # (n_kf, 0, 2) = the marker-free sentinel for resume.
            corners=np.zeros((n_kf, 0, 2), np.float32) if markerless else np.stack(kf_corners),
            frames_total=frame_idx,
            kf_scale=p2s,
            indices=np.asarray(kf_indices, np.int64),
        )

    with metrics.stage("pass2_orb"):
        oc = config.orb
        orb_batch = orb.detect_and_compute(
            kf_stack,
            max_features=oc.num_features,
            num_levels=oc.num_levels,
            scale_factor=oc.scale_factor,
            fast_threshold=oc.fast_threshold,
            grid_cells=oc.grid_cells,
        )

    with metrics.stage("pass2_matching"):
        mc = config.matcher
        pair_matches = matching.match_descriptors(
            orb_batch.descriptors[:-1], orb_batch.descriptors[1:],
            orb_batch.mask[:-1], orb_batch.mask[1:],
            ratio=mc.ratio, max_distance=mc.max_distance,
            max_matches=mc.max_matches, cross_check=mc.cross_check,
        )
        metrics.count_async("matches_per_pair", pair_matches.mask.sum(dim=1))

    with metrics.stage("pass2_tracks"):
        store = tracks_mod.make_store(config.tracks.max_tracks, n_kf, device=device)
        store = tracks_mod.update_tracks_scan(
            store, pair_matches.query_idx, pair_matches.train_idx, pair_matches.mask,
            orb_batch.xy, orb_batch.octave,
        )
        store = tracks_mod.finalize_tracks(store)
        metrics.count_async("tracks", store.used.sum())

    h, w = kf_stack.shape[1:]
    if markerless:
        ext_refined, intr, dist_coefs = _markerless_poses(config, metrics, store, n_kf, int(w), int(h), p2s, device)
    else:
        ext_refined, intr, dist_coefs = _board_poses(config, metrics, kf_stack, kf_corners, int(w), int(h), p2s, device)

    with metrics.stage("triangulation"):
        store, tri_valid, n_outlier, track_parallax = _triangulate_gate(
            store, ext_refined, intr, dist_coefs, config.tracks.triangulation,
            config.orb.scale_factor, config.tracks.min_parallax_deg,
            reproj_gate=config.tracks.max_reproj_px / p2s,
        )
        metrics.count_async("triangulated", tri_valid.sum())
        metrics.count_async("outlier_tracks_dropped", n_outlier)

    return _finish_preba(
        store, tri_valid, track_parallax, ext_refined, intr, dist_coefs,
        (int(w), int(h)), p2s, float(config.orb.scale_factor), markerless,
    )


def _board_poses(config, metrics, kf_stack, kf_corners, w, h, p2s, device):
    """Board geometry: sub-pixel corners, Zhang calibration, planar PnP and
    pose-only BA. Returns (extrinsics (F, 3, 4), K, distortion (5,))."""
    pattern = config.chessboard.pattern
    with metrics.stage("corner_refine"):
        # Corners are in full-resolution pixels; pass 2 works at 1/p2s.
        corners = torch.from_numpy(np.stack(kf_corners)).to(device) / p2s
        corners = chessboard.refine_corners_subpix(
            kf_stack, corners, win=config.chessboard.subpix_window,
            iters=config.chessboard.subpix_iters,
        )

    with metrics.stage("calibration"):
        obj_z0 = calibration.chessboard_object_points(pattern, corners.dtype, device)
        cb = config.chessboard
        calib = calibration.calibrate(
            corners, obj_z0, (w, h), num_dist=cb.calib_num_dist,
            fix_principal_point=cb.calib_fix_principal_point,
            single_focal=cb.calib_single_focal,
        )
        metrics.count_async("calibration_rms_px", calib.rms)
        numerics.check_finite("calibration", intrinsics=calib.intrinsics, dist=calib.dist)
        intr, dist_coefs = calib.intrinsics, calib.dist

    with metrics.stage("pose_estimation"):
        side = config.chessboard.side_length
        und_corners, poses = _pose_stage(corners, intr, dist_coefs, obj_z0, side)

    with metrics.stage("pose_ba"):
        ext0 = projection.extrinsics_from_params(poses)
        # The reference's tighter pose-only stopping rule.
        pose_cfg = dataclasses.replace(
            config.solver, ftol=min(config.solver.ftol, 1e-7),
            max_iters=max(config.solver.max_iters, 100),
        )
        ext_refined, pose_ba_res = bundle_adjust.adjust_pose(
            ext0, intr, und_corners.reshape(-1, 2), pattern=pattern,
            side_length=side, config=pose_cfg,
        )
        metrics.count_async("pose_ba_rmse_px", pose_ba_res.rmse)
        numerics.check_finite("pose_ba", extrinsics=ext_refined)

    return ext_refined, intr, dist_coefs


def _markerless_poses(config, metrics, store, n_kf, w, h, p2s, device):
    """Marker-free geometry: an assumed pinhole K (``markerless_focal`` is in
    full-resolution pixels, so it divides by the pass-2 downscale; without
    it the prior 1.2 * max(w, h) of the working image), zero distortion, and
    the keyframe pose chain. Output is up to scale."""
    focal = config.markerless_focal / p2s if config.markerless_focal else 1.2 * max(w, h)
    intr = torch.tensor(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]], dtype=torch.float32, device=device
    )
    dist_coefs = torch.zeros(5, dtype=torch.float32, device=device)
    with metrics.stage("pose_chain"):
        ext_refined, chain_inliers = _chain_keyframe_poses(
            store, intr, n_kf, reproj_gate=config.tracks.max_reproj_px / p2s
        )
        metrics.count("pose_chain_inliers", chain_inliers)
        numerics.check_finite("pose_chain", extrinsics=ext_refined)
    return ext_refined, intr, dist_coefs


def _finish_preba(store, tri_valid, track_parallax, ext_refined, intr, dist_coefs,
                  image_size, p2s, scale_factor, markerless=False) -> PreBA:
    """BA observation lists from the track store: tracks with >= 2
    observations that passed the gate, their observations in track-major
    order, inverse-octave-sigma weights, per-point sigma and parallax."""
    n_obs_per = store.obs_mask.sum(1)
    track_ids = torch.nonzero(store.used & (n_obs_per >= 2))[:, 0]
    t_idx, f_idx = torch.nonzero(store.obs_mask[track_ids], as_tuple=True)
    sel = track_ids[t_idx]
    obs = store.coords[sel, f_idx]
    obs_sigma = torch.tensor(scale_factor, dtype=torch.float32, device=obs.device) ** store.octaves[
        sel, f_idx
    ].to(torch.float32)

    tri_valid_t = tri_valid[track_ids]
    obs_keep = tri_valid_t[t_idx]
    n_t = track_ids.shape[0]
    n_per = torch.bincount(t_idx, minlength=n_t).to(torch.float32)
    sum_per = torch.zeros(n_t, dtype=torch.float32, device=obs.device).index_add_(0, t_idx, obs_sigma)
    sigma_mean = torch.where(n_per > 0, sum_per / torch.clamp(n_per, min=1), torch.full_like(n_per, torch.inf))
    remap = torch.full((n_t,), -1, dtype=torch.int64, device=obs.device)
    remap[tri_valid_t] = torch.arange(int(tri_valid_t.sum()), device=obs.device)
    return PreBA(
        ext_refined=ext_refined,
        intrinsics=intr,
        dist=dist_coefs,
        points=store.points[track_ids][tri_valid_t],
        obs=obs[obs_keep],
        fidx=f_idx[obs_keep],
        pidx=remap[t_idx[obs_keep]],
        obs_weight=(1.0 / obs_sigma)[obs_keep],
        point_sigma=sigma_mean[tri_valid_t],
        point_parallax=track_parallax[track_ids][tri_valid_t],
        image_size=image_size,
        kf_scale=p2s,
        markerless=markerless,
    )


def _reconstruct_to_ba(video, config, known_corners, metrics, ckpt, device) -> PreBA:
    """PASS 1 + PASS 2 + geometry up to (not including) the global BA.

    The reference's branches: a keyframe checkpoint; ``assume_markerless``
    (one marker-free pass 1, no board hunt); else the board-gated pass 1
    and the board detection, and with fewer than 3 board keyframes and
    ``markerless_fallback`` a second, marker-free pass 1."""
    pattern = config.chessboard.pattern
    run_pass1 = _run_pass1_host if config.pass1_backend == "host" else _run_pass1
    kf_stack, kf_frames = None, []
    markerless = False
    if ckpt.has("keyframes"):
        data = ckpt.load("keyframes")
        kf_stack = torch.from_numpy(data["greys"].astype(np.float32)).to(device)
        corners_arr = data["corners"]
        markerless = corners_arr.shape[1] == 0  # the marker-free sentinel
        kf_corners = [None] * len(corners_arr) if markerless else list(corners_arr)
        frame_idx = int(data["frames_total"])
        p2s = int(data["kf_scale"])
        kf_indices = [int(i) for i in data["indices"]]
        metrics.count("frames_total", frame_idx)
    elif config.assume_markerless and known_corners is None:
        # Caller-declared board-free video: no board hunt.
        markerless = True
        kf_frames, kf_corners, _, kf_indices, frame_idx, _, p2s = run_pass1(
            video, config, pattern, None, metrics, device, markerfree=True
        )
    else:
        kf_frames, kf_corners, kf_small, kf_indices, frame_idx, scale, p2s = run_pass1(
            video, config, pattern, known_corners, metrics, device
        )
        with metrics.stage("board_detect"):
            kf_frames, kf_corners, kf_indices = _resolve_board_corners(
                kf_frames, kf_corners, kf_small, kf_indices, pattern, scale, config.chessboard
            )
        if len(kf_corners) < 3 and config.markerless_fallback and known_corners is None:
            # Board-free video: keyframe selection again without the board
            # gate; the poses come from the marker-free chain, up to scale.
            markerless = True
            kf_frames, kf_corners, _, kf_indices, frame_idx, _, p2s = run_pass1(
                video, config, pattern, None, metrics, device, markerfree=True
            )
    n_kf = len(kf_corners)
    metrics.count("keyframes", n_kf)
    if markerless:
        metrics.count("markerless", True)
    metrics.count("kf_scale", p2s)
    metrics.count("keyframe_indices", list(kf_indices))
    if n_kf < 3:
        raise ValueError(
            f"only {n_kf} keyframes" + ("" if markerless else " with a visible chessboard")
            + "; need >= 3 (check the video shows the calibration target, or enough "
            "camera motion for the marker-free fallback)"
        )
    if n_kf > config.tracks.max_keyframes:
        raise ValueError(
            f"{n_kf} keyframes exceed tracks.max_keyframes={config.tracks.max_keyframes}; "
            "raise the capacity or the keyframe threshold"
        )
    return _pass2_to_preba(
        config, metrics, ckpt, kf_stack, kf_frames, kf_corners, kf_indices, frame_idx, p2s, markerless, device
    )


def _config_from_param_dicts(config, lk_params, feature_params):
    """Fold the reference's cv2 parameter dicts (``lk_params``: winSize,
    maxLevel, criteria; ``feature_params``: maxCorners, qualityLevel,
    minDistance, blockSize) into ``config.keyframe``."""
    kf = config.keyframe
    if lk_params:
        if "winSize" in lk_params:
            kf = dataclasses.replace(kf, window=int(lk_params["winSize"][0]))
        if "maxLevel" in lk_params:
            kf = dataclasses.replace(kf, pyramid_levels=int(lk_params["maxLevel"]) + 1)
        if "criteria" in lk_params:
            _, iters, eps = lk_params["criteria"]
            kf = dataclasses.replace(kf, max_iters=int(iters), eps=float(eps))
    if feature_params:
        if "maxCorners" in feature_params:
            kf = dataclasses.replace(kf, max_corners=int(feature_params["maxCorners"]))
        if "qualityLevel" in feature_params:
            kf = dataclasses.replace(kf, quality_level=float(feature_params["qualityLevel"]))
        if "minDistance" in feature_params:
            kf = dataclasses.replace(kf, min_distance=int(feature_params["minDistance"]))
        if "blockSize" in feature_params:
            kf = dataclasses.replace(kf, block_size=int(feature_params["blockSize"]))
    return dataclasses.replace(config, keyframe=kf)


def process(
    video,
    path: Optional[str] = None,
    lk_params: Optional[dict] = None,
    feature_params: Optional[dict] = None,
    flann_params: Optional[dict] = None,
    config: PipelineConfig = DEFAULT_CONFIG,
    known_corners: Optional[np.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
) -> ProcessResult:
    """Video -> bundle-adjusted point cloud + volume (+ ``<path>Cloud.ply``).

    The reference's entry point, plus ``device``: the whole device half
    runs there ("cuda" by default). Without CUDA a "cuda" device raises;
    the run never moves to the CPU on its own (pass ``device="cpu"`` for
    that).

    Args:
      video: path (.npy/.y4m) or (T, H, W[, 3]) uint8 array.
      path: output prefix for ``<path>Cloud.ply`` (skipped if None).
      lk_params / feature_params / flann_params: the reference's cv2
        parameter dicts, folded into ``config.keyframe``; ``flann_params``
        is accepted and ignored (matching is exact).
      config: the config tree. Without ``known_corners`` it needs
        ``assume_markerless``, or ``pass1_backend="device"`` and
        ``chessboard.detector="device"``.
      known_corners: optional (T, N, 2) board corners per frame; without
        them the device detector finds the board, and a board-free video
        takes the marker-free path (with ``markerless_fallback``): then the
        reconstruction is up to scale and ``metrics["counters"]["markerless"]``
        is set.
      checkpoint_dir: per-stage npz artifacts; a re-run resumes after the
        keyframe stage.
    """
    device = _make_device(device)
    config = _config_from_param_dicts(config, lk_params, feature_params)
    _check_supported(config, known_corners)
    metrics = Metrics()
    ckpt = StageCheckpointer(checkpoint_dir)
    with full_fp32(), torch.no_grad():
        pre = _reconstruct_to_ba(video, config, known_corners, metrics, ckpt, device)
        return _solve_and_finish(pre, config, metrics, ckpt, path)


# --------------------------------------------------------------------------
# Global BA + volume
# --------------------------------------------------------------------------


def _volume_confidence(arc_deg: float, elong: float, n_item: int, config) -> Dict[str, Any]:
    """LOW confidence in the estimator's validated weak regime (narrow arc x
    elongated item) or for a sparse item cloud (thresholds in VolumeConfig)."""
    vc = config.volume
    low = n_item >= 8 and arc_deg < vc.confidence_min_arc_deg and elong > vc.confidence_max_elongation
    reason = ""
    if low:
        reason = (
            f"view arc {arc_deg:.0f} deg < {vc.confidence_min_arc_deg:.0f} and "
            f"item elongation {elong:.2f} > {vc.confidence_max_elongation:.2f}: "
            "the symmetric-completion hull cannot observe the item's far "
            "long-axis extent from this arc (validated weak case: ~+40%)"
        )
    elif n_item < vc.confidence_min_item_points:
        low = True
        reason = (
            f"item cloud has only {n_item} points "
            f"(< {vc.confidence_min_item_points}): the trimmed support "
            "underreads a sparsely sampled surface — use a longer clip or "
            "denser features"
        )
    return {
        "low_confidence": bool(low),
        "view_arc_deg": round(arc_deg, 2),
        "elongation": round(elong, 3),
        "reason": reason,
        "n_item_points": n_item,
    }


def _view_regime(ext4, points, item_mask):
    """(view_arc_deg, elongation): the volume-confidence predictors."""
    n_item = torch.clamp(item_mask.sum(), min=1)
    pts_f = points.to(torch.float32)
    centroid = torch.sum(torch.where(item_mask[:, None], pts_f, torch.zeros_like(pts_f)), dim=0) / n_item
    centers = -torch.einsum("fij,fi->fj", ext4[:, :3, :3], ext4[:, :3, 3])
    d = centers - centroid[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-9)
    arc = torch.amax(torch.arccos(torch.clamp(d @ d.T, -1.0, 1.0)))
    x = torch.where(item_mask[:, None], pts_f - centroid[None, :], torch.zeros_like(pts_f))
    eig = torch.linalg.eigvalsh((x.T @ x) / n_item)  # ascending
    elong = torch.sqrt(eig[2] / torch.clamp(eig[1], min=1e-12))
    return torch.rad2deg(arc), elong


def _estimate_volume(pts, intrinsics, ext4, image_size, config, point_sigma, point_parallax, kf_scale, use_plane=True):
    """Hull + carved volume of the gated item points. Returns a (6,) tensor
    [hull, carve, n_item, 0, view_arc_deg, elongation]; the caller applies
    the too-few-points NaN rule. ``use_plane=False``: marker-free world
    frame, no board plane to gate on (the volume is in the monocular
    gauge's units^3)."""
    vc = config.volume
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    pmask = valid
    if vc.max_point_sigma > 0:
        precise = valid & (point_sigma <= vc.max_point_sigma)
        pmask = torch.where(precise.sum() >= 32, precise, pmask)
    if vc.min_parallax_deg > 0:
        certain = pmask & (point_parallax >= vc.min_parallax_deg)
        pmask = torch.where(certain.sum() >= 32, certain, pmask)
    item_mask = volume_mod.split_item_points(pts, pmask, use_plane=use_plane)
    proj_new = projection.projection_from_extrinsic(intrinsics, ext4[:, :3, :])
    proj_mask = torch.ones(ext4.shape[0], dtype=torch.bool, device=pts.device)
    hull, carve = volume_mod.hull_and_carved_volume(
        pts, item_mask, proj_new, proj_mask, image_size=image_size,
        resolution=vc.voxel_resolution, num_directions=vc.hull_directions,
        trim=vc.hull_trim,
        # carve_dilation is in full-resolution pixels; the projections are
        # in 1/kf_scale units, and the silhouette grid step shrinks with it.
        dilation=max(1, round(vc.carve_dilation / kf_scale)),
        grid_step=max(1, 4 // kf_scale),
        close_frac=vc.carve_close_frac, vote_frac=vc.carve_vote_frac,
        support_mask=item_mask, trim_ref=vc.hull_trim_ref,
    )
    arc_deg, elong = _view_regime(ext4, pts, item_mask)
    return torch.stack(
        [hull.to(torch.float32), carve.to(torch.float32), item_mask.sum().to(torch.float32),
         torch.zeros((), device=pts.device), arc_deg.to(torch.float32), elong.to(torch.float32)]
    )


def _incremental_ba(pre: PreBA, solver_cfg, metrics):
    """Online refinement (the reference's ``incremental_ba``): after each
    keyframe, the BA over the observations of keyframes ``< k``, for k = 3..F;
    the last prefix is the global problem. Each solve starts from the
    previous one's parameters and exit damping, one notch down and capped at
    ``init_lambda`` (an uncapped carry stops the next prefix after one tiny
    step). Returns the last solve's (points, (F, 4, 4) extrinsics, result)."""
    ext_cur, pts_cur, lam_cur = pre.ext_refined, pre.points, None
    rmse_steps, iters_total = [], 0
    for k in range(3, pre.ext_refined.shape[0] + 1):
        pts_cur, ext4, ba_res = bundle_adjust.adjust_points(
            ext_cur, pre.intrinsics, pts_cur, pre.obs, pre.fidx, pre.pidx,
            mask=pre.fidx < k, weights=pre.obs_weight, config=solver_cfg, init_lambda=lam_cur,
        )
        ext_cur = ext4[:, :3, :]
        lam_cur = min(float(ba_res.final_lambda) * solver_cfg.lambda_down, solver_cfg.init_lambda)
        rmse_steps.append(float(ba_res.rmse))
        iters_total += int(ba_res.iterations)
    metrics.count("ba_rmse_px_steps", rmse_steps)
    metrics.count("ba_iterations_total", iters_total)
    return pts_cur, ext4, ba_res


def _volume_of(pts, ext4, pre: PreBA, config, metrics):
    """Hull and carved volume of a solved cloud (NaN with fewer than 8 item
    points) and the volume-confidence regime check, counted into
    ``metrics``. Returns (hull, carved, volume_confidence)."""
    with metrics.stage("volume"):
        fused = _estimate_volume(
            pts, pre.intrinsics, ext4, pre.image_size, config,
            pre.point_sigma, pre.point_parallax, pre.kf_scale, use_plane=not pre.markerless,
        ).cpu().numpy()
    n_item = int(fused[2])
    if n_item >= 8:
        vol_hull, vol_carve = float(fused[0]), float(fused[1])
    else:
        vol_hull = vol_carve = float("nan")
    metrics.count("item_points", n_item)
    metrics.count("volume_hull", vol_hull)
    metrics.count("volume_carved", vol_carve)
    volume_confidence = _volume_confidence(float(fused[4]), float(fused[5]), n_item, config)
    metrics.count("volume_low_confidence", volume_confidence["low_confidence"])
    metrics.count("volume_view_arc_deg", volume_confidence["view_arc_deg"])
    metrics.count("volume_elongation", volume_confidence["elongation"])
    return vol_hull, vol_carve, volume_confidence


def _solve_and_finish(pre: PreBA, config, metrics, ckpt, path) -> ProcessResult:
    """Global BA (or incremental prefix solves) + volume + PLY from a PreBA."""
    with metrics.stage("bundle_adjustment"):
        if config.incremental_ba:
            new_pts, new_ext, ba_res = _incremental_ba(pre, config.solver, metrics)
        else:
            new_pts, new_ext, ba_res = bundle_adjust.adjust_points(
                pre.ext_refined, pre.intrinsics, pre.points, pre.obs, pre.fidx, pre.pidx,
                weights=pre.obs_weight, config=config.solver,
            )
        metrics.count_async("ba_rmse_px", ba_res.rmse)
        metrics.count("ba_iterations", ba_res.iterations)
        numerics.check_finite("bundle_adjustment", points=new_pts, extrinsics=new_ext)
        metrics.count("points", int(new_pts.shape[0]))
        if ckpt.enabled:
            ckpt.save(
                "cloud",
                points=new_pts.cpu().numpy(), extrinsics=new_ext.cpu().numpy(),
                intrinsics=pre.intrinsics.cpu().numpy(), distortion=pre.dist.cpu().numpy(),
                rmse=float(ba_res.rmse),
            )

    vol_hull, vol_carve, volume_confidence = _volume_of(new_pts, new_ext, pre, config, metrics)
    new_pts_np = new_pts.cpu().numpy()
    ply_path = None
    if path is not None:
        with metrics.stage("ply_export"):
            ply_path = ply_mod.write_ply(str(path) + "Cloud.ply", new_pts_np)
    return ProcessResult(
        points=new_pts_np,
        extrinsics=new_ext.cpu().numpy(),
        intrinsics=pre.intrinsics.cpu().numpy(),
        distortion=pre.dist.cpu().numpy(),
        volume=vol_hull,
        volume_carved=vol_carve,
        ply_path=ply_path,
        reprojection_rmse=float(ba_res.rmse),
        metrics=metrics.as_dict(),
        volume_confidence=volume_confidence,
    )
