"""The first calls the paths make of the two chain kernels' dispatch points,
``klt.lucas_kanade`` and ``ransac.refine_relative_pose``, recorded on the
card for the benches to time and compare at (``klt_bench``,
``relpose_bench``: ``--paths``) and for ``chip_smoke.py`` to hold the
kernels to their plain versions at.

``record(device, paths)`` renders what a path needs and runs it:

  scan: the headline clip (300 frames, 1920x1080) through ``process`` with
    ``detector_config(headline_config())``: the video-alone keyframe scan's
    first Lucas-Kanade call between two frames;
  odometry: ``chain_poses`` over the first two frames of the board-free
    clip (``markerless_clip``): its step's Lucas-Kanade call and refinement;
  bootstrap: the board-free clip through ``process`` with
    ``markerless_config()``: the marker-free bootstrap's refinement;
  two_view: ``reconstruct_two_view`` on its frames 0 and 4: both calls.
"""

from __future__ import annotations

import inspect
from typing import Dict, Sequence

import torch

from meatmodeler_tpu_torch.geometry import ransac
from meatmodeler_tpu_torch.odometry import chain_poses
from meatmodeler_tpu_torch.ops import klt
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.tools.profile_headline import (
    detector_config,
    headline_clip,
    headline_config,
    markerless_clip,
    markerless_config,
    recording,
)
from meatmodeler_tpu_torch.two_view import reconstruct_two_view

__all__ = ["PATHS", "lk_call_case", "record", "relpose_call_case"]

PATHS = ("scan", "odometry", "bootstrap", "two_view")


def lk_call_case(call):
    """A recorded ``klt.lucas_kanade`` call as a (prev, curr, points, mask,
    initial flow, settings) case."""
    bound = inspect.signature(klt.lucas_kanade).bind(*call[0], **call[1])
    bound.apply_defaults()
    a = bound.arguments
    s = {k: a[k] for k in ("win", "levels", "max_iters", "eps")}
    return a["prev_pyr"], a["curr_pyr"], a["points"], a["point_mask"], a["initial_flow"], s


def relpose_call_case(call):
    """A recorded ``ransac.refine_relative_pose`` call as its (rvec, tvec,
    pts1, pts2, mask, K), with the default iterations."""
    bound = inspect.signature(ransac.refine_relative_pose_reference).bind(*call[0], **call[1])
    bound.apply_defaults()
    a = bound.arguments
    if a["iters"] != 15:
        raise AssertionError(f"a caller asked for {a['iters']} refinement iterations, not 15")
    return tuple(a[k] for k in ("rvec", "tvec", "pts1", "pts2", "mask", "intrinsics"))


def record(device, paths: Sequence[str] = PATHS) -> Dict[str, Dict[str, tuple]]:
    """{"lk": {path: case}, "relpose": {path: args}}: the first call each
    of ``paths`` makes (see the module's note)."""
    out = {"lk": {}, "relpose": {}}
    if "scan" in paths:
        _, frames, _ = headline_clip(device)
        with recording(klt, "lucas_kanade") as calls:
            process(frames, config=detector_config(headline_config()), device=device.type)
        # The scan's first call tracks its start frame against itself.
        out["lk"]["scan"] = next(
            case for case in map(lk_call_case, calls) if not torch.equal(case[0][0], case[1][0])
        )
        del frames, calls
    if not set(paths) & {"odometry", "bootstrap", "two_view"}:
        return out
    scene, frames, _ = markerless_clip(device)
    runs = {
        "odometry": lambda: chain_poses(frames[:2], scene.intrinsics, device=device.type),
        "bootstrap": lambda: process(frames, config=markerless_config(), device=device.type),
        "two_view": lambda: reconstruct_two_view(frames[0], frames[4], scene.intrinsics, device=device.type),
    }
    for path in ("odometry", "bootstrap", "two_view"):
        if path not in paths:
            continue
        with recording(klt, "lucas_kanade") as lk_calls, recording(ransac, "refine_relative_pose") as refines:
            runs[path]()
        out["relpose"][path] = relpose_call_case(refines[0])
        if path != "bootstrap":
            out["lk"][path] = lk_call_case(lk_calls[0])
    return out
