"""Several videos reconstructed together, their BA solves batched (torch
twin of ``meatmodeler_tpu/parallel/batch.py``).

Each video's pass 1, board resolution, pass 2 and geometry run per video
(a batch prepass where the clips allow it, else the per-video path of
``process``) on one CUDA device; then every video's BA problem is padded to
common capacities and solved in one batched LM (``bundle_adjust.
solve_ba_batch``, the reference's ``vmap(solve_ba)``), or, given a
``mesh``, split over its GPUs (``sharded.solve_ba_batch``); then volume and
PLY per video.

What the reference adds for its TPU link is left out: the compile warm-up
thread, the pass-2 prefetch, the packed single-buffer fetches, the
1024-point and 8-keyframe volume padding, and the debug marks.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu_torch.geometry import projection
from meatmodeler_tpu_torch.io import native_ops
from meatmodeler_tpu_torch.io import ply as ply_mod
from meatmodeler_tpu_torch.io.native_pass1 import HostPass1Scanner, host_pass1_available
from meatmodeler_tpu_torch.ops import clahe
from meatmodeler_tpu_torch.parallel import sharded
from meatmodeler_tpu_torch.pipeline import (
    ProcessResult,
    _auto_scales,
    _check_supported,
    _known_board,
    _make_device,
    _make_keyframe_scan,
    _pass2_to_preba,
    _reconstruct_to_ba,
    _resolve_board_corners,
    _volume_of,
    full_fp32,
)
from meatmodeler_tpu_torch.solvers import bundle_adjust
from meatmodeler_tpu_torch.utils import Metrics
from meatmodeler_tpu_torch.utils.checkpoint import StageCheckpointer
from meatmodeler_tpu_torch.utils.numerics import load_cuda_linalg
from meatmodeler_tpu_torch.utils.profiling import profile_run

__all__ = ["process_batch"]


def process_batch(
    videos: Sequence,
    config: PipelineConfig = DEFAULT_CONFIG,
    paths: Optional[Sequence[Optional[str]]] = None,
    known_corners: Optional[Sequence[Optional[np.ndarray]]] = None,
    device="cuda",
    mesh: Optional[sharded.Mesh] = None,
) -> List[ProcessResult]:
    """Reconstruct several videos with their BA solves batched.

    Everything runs on ``device`` ("cuda" by default; without CUDA it
    raises) but, with a ``mesh``, the batched solve: the batch is padded to
    a multiple of its ``data`` axis with copies of the last problem (their
    results are dropped) and its lanes are split over the data devices.

    Args:
      videos: video sources (paths, or (T, H, W, 3) uint8 arrays; a batch of
        same-shape arrays takes the batch prepass: the host C++ keyframe
        scan from frame 0 and the device board detector).
      config: shared config tree. Videos without known corners need
        ``chessboard.detector="device"`` (the others detect with cv2).
      paths: optional per-video output prefixes (``<path>Cloud.ply``).
      known_corners: optional per-video ground-truth board corners.
      mesh: a ``sharded.make_mesh()`` mesh for the solve, or None.

    Returns:
      One ProcessResult per video, in input order.
    """
    device = _make_device(device)
    n = len(videos)
    paths = list(paths) if paths is not None else [None] * n
    known_corners = list(known_corners) if known_corners is not None else [None] * n
    if any(k is None for k in known_corners):
        # Before any work: the detector rule. (The pass-1 rule applies only
        # to a video left to the per-video path; the prepass scans on the
        # host from frame 0 whatever ``pass1_backend`` says.)
        _check_supported(dataclasses.replace(config, pass1_backend="device"), None)
    metrics_list = [Metrics() for _ in range(n)]
    load_cuda_linalg(device)
    with profile_run(), full_fp32(), torch.no_grad():
        prepped = _batch_prepass(videos, config, known_corners, metrics_list, device)

        def reconstruct(i):
            with torch.no_grad():  # grad mode is per thread
                if prepped is not None and prepped[i] is not None:
                    return _pass2_to_preba(
                        config, metrics_list[i], StageCheckpointer(None), markerless=False, device=device,
                        **prepped[i],
                    )
                _check_supported(config, known_corners[i])
                return _reconstruct_to_ba(
                    videos[i], config, known_corners[i], metrics_list[i], StageCheckpointer(None), device
                )

        # Two workers overlap one video's host work with another's device
        # work. Both queue on the device's one default stream, in the order
        # the host issues them, so a tensor handed between them is ready
        # for whatever reads it next.
        with ThreadPoolExecutor(max_workers=min(2, max(n, 1))) as pool:
            pres = list(pool.map(reconstruct, range(n)))
        return _solve_and_finish_batch(pres, config, metrics_list, paths, mesh)


def _batch_prepass(videos, config, known_corners, metrics_list, device):
    """Pass 1 and board resolution for a batch of same-shape in-memory
    ``uint8`` clips, as the reference's ``_batch_prepass``: each video is
    scanned from frame 0 by the host C++ scan (the device scan where the
    library does not build), and its keyframes' boards are found by the
    device detector on the scan's CLAHE'd smalls. Returns a per-video list
    of ``_pass2_to_preba`` arguments, or None for a video with fewer than 3
    board keyframes (it takes the per-video path); None outright when the
    batch does not qualify (marker-free, ``bgr_lab``, not uniform arrays)."""
    if config.assume_markerless or config.pass2_enhance != "grey":
        return None
    if not all(isinstance(v, np.ndarray) and v.ndim == 4 and v.dtype == np.uint8 for v in videos):
        return None
    if len({v.shape for v in videos}) != 1:
        return None
    t, h, w = videos[0].shape[:3]
    if t < 2:
        return None
    scale, p2s = _auto_scales(videos[0], config.pass1_downscale, config.pass2_downscale)
    pattern = config.chessboard.pattern
    use_cpp = host_pass1_available()
    if not use_cpp:
        init_carry, scan_chunk = _make_keyframe_scan(config)

    out = []
    for clip, known, metrics in zip(videos, known_corners, metrics_list):
        with metrics.stage("pass1_keyframes"):
            small = native_ops.bgr_to_grey_down(clip, scale)
            if use_cpp:
                scanner = HostPass1Scanner(config, small.shape[1], small.shape[2], full_width=w)
                flags, enh = scanner.scan(small, bootstrap_at=0)
                flags = flags[1:]
            else:
                enh = clahe.clahe(torch.from_numpy(small).to(device).to(torch.float32))
                flags = scan_chunk(init_carry(enh[0]), enh[1:], width_scale=scale)[1].cpu().numpy()
            kf_idx = [0] + [int(i) + 1 for i in np.nonzero(flags)[0]]
        if len(kf_idx) > config.tracks.max_keyframes:
            raise ValueError(
                f"{len(kf_idx)} keyframes exceed tracks.max_keyframes={config.tracks.max_keyframes}; "
                "raise the capacity or the keyframe threshold"
            )
        metrics.count("frames_total", t)
        metrics.count("keyframes_selected", len(kf_idx))
        kf_frames = list(native_ops.bgr_to_grey_down(np.ascontiguousarray(clip[kf_idx]), p2s))
        if known is not None:
            # Canonicalised known corners, without the orientation anchoring
            # of the per-video path (as the reference's prepass).
            kept = kf_frames, [_known_board(known, g, pattern) for g in kf_idx], kf_idx
        else:
            if use_cpp:  # the scan's CLAHE'd smalls, one byte per pixel
                kf_small = torch.from_numpy(np.clip(np.round(enh[kf_idx]), 0, 255).astype(np.uint8)).to(device)
                kf_small = kf_small.to(torch.float32)
            else:
                kf_small = enh[kf_idx]
            with metrics.stage("board_detect"):
                kept = _resolve_board_corners(
                    kf_frames, [None] * len(kf_idx), kf_small, kf_idx, pattern, scale, config.chessboard
                )
        kf_frames, kf_corners, kf_indices = kept
        if len(kf_frames) < 3:
            out.append(None)
            continue
        metrics.count("keyframes", len(kf_frames))
        metrics.count("kf_scale", p2s)
        metrics.count("keyframe_indices", [int(i) for i in kf_indices])
        metrics.count("batch_fast_prepass", True)
        out.append(dict(
            kf_stack=None, kf_frames=kf_frames, kf_corners=kf_corners, kf_indices=kf_indices,
            frame_idx=t, p2s=p2s,
        ))
    return out


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def _solve_and_finish_batch(pres, config, metrics_list, paths, mesh=None) -> List[ProcessResult]:
    """Pad every video's BA problem to the batch's largest (F, P, N), solve
    them as one batch (over ``mesh``'s data devices when given), then volume
    and PLY per video."""
    f_max = max(p.ext_refined.shape[0] for p in pres)
    p_max = max(p.points.shape[0] for p in pres)
    o_max = max(p.obs.shape[0] for p in pres)
    device = pres[0].points.device
    # The data axis must divide the batch: pad with copies of the last
    # problem.
    n_solve = len(pres) if mesh is None else -(-len(pres) // mesh.shape["data"]) * mesh.shape["data"]
    lanes = list(pres) + [pres[-1]] * (n_solve - len(pres))
    problem = bundle_adjust.BAProblem(*(
        torch.stack(fields) for fields in zip(*(
            (
                _pad_to(projection.params_from_extrinsics(p.ext_refined), f_max),
                _pad_to(p.points, p_max),
                p.intrinsics,
                _pad_to(p.obs, o_max),
                _pad_to(p.fidx, o_max),
                _pad_to(p.pidx, o_max),
                torch.arange(o_max, device=device) < p.obs.shape[0],
                _pad_to(p.obs_weight, o_max),
            )
            for p in lanes
        ))
    ))
    t0 = time.perf_counter()
    if mesh is None:
        result = bundle_adjust.solve_ba_batch(problem, config=config.solver)
    else:
        result = sharded.solve_ba_batch(mesh, problem, config=config.solver)
    rmse_all = result.rmse.cpu().numpy()
    iters_all = result.iterations.cpu().numpy()
    solve_s = time.perf_counter() - t0

    out: List[ProcessResult] = []
    for i, (pre, metrics, path) in enumerate(zip(pres, metrics_list, paths)):
        n_kf, n_pts = pre.ext_refined.shape[0], pre.points.shape[0]
        pts = result.points[i, :n_pts]
        ext4 = projection.extrinsics_from_params(result.cam_params[i, :n_kf], homogeneous=True)
        rmse = float(rmse_all[i])
        metrics.count("ba_rmse_px", rmse)
        metrics.count("ba_iterations", int(iters_all[i]))
        metrics.count("batch_solve_s", solve_s)  # the whole batch's solve
        metrics.count("points", n_pts)
        vol_hull, vol_carve, volume_confidence = _volume_of(pts, ext4, pre, config, metrics)
        pts_np = pts.cpu().numpy()
        ply_path = ply_mod.write_ply(str(path) + "Cloud.ply", pts_np) if path is not None else None
        out.append(ProcessResult(
            points=pts_np,
            extrinsics=ext4.cpu().numpy(),
            intrinsics=pre.intrinsics.cpu().numpy(),
            distortion=pre.dist.cpu().numpy(),
            volume=vol_hull,
            volume_carved=vol_carve,
            ply_path=ply_path,
            reprojection_rmse=rmse,
            metrics=metrics.as_dict(),
            volume_confidence=volume_confidence,
        ))
    return out
