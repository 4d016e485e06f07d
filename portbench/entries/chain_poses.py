"""Runs ``meatmodeler_tpu_torch.odometry.chain_poses``: a grey video
and K in, one camera pose a frame out (a per-frame tracker: Lucas-Kanade
tracks, a LO-RANSAC relative pose a step, scale chained by depth ratios).

The configuration file gives the scene (its K is the scene's), the clip
length and the program's configuration as data (its keyframe block sets the
tracker); the traffic file the options it sets. Clips are rendered on the
card by the frozen renderer and kept on the host as uint8 arrays.

While a clip runs the runner keeps references, a step at a time, to what
the tracker was given and gave back (``klt.lucas_kanade``: start points,
point mask, tracked points, status) and to the relative pose's input pairs
and answer (``ransac.estimate_relative_pose``); it forms nothing on the
device. The numbers compared, each the worst over the clip's steps but
where said:

- ``track_step_px``: a step's 90th percentile (nearest rank), over the
  points that the reference's own tracking from the same start points
  tracks or the program reports tracked, of the update one more float64
  Lucas-Kanade iteration of the reference would make at the program's
  tracked position, on the reference's own enhanced frames; a point the
  program reports lost where the reference tracks it counts as unbounded,
  and so does every point of a step whose reported count (``num_tracked``)
  is not the count of the points the tracker marked tracked;
- ``pose_gain``: the share of a step's robust Sampson cost at the program's
  relative pose that one float64 step of the reference removes, the median
  over the steps (the mean of the two middle values for an even count), and
  ``pose_gain_p90`` its 90th percentile over the steps (nearest rank), so a
  fault on a tenth of the steps or more shows (the worst step is printed
  beside the check: a few steps' refinement stops short on sound runs);
- ``scale_gap``: a step's scale against the reference's float64 depth
  ratio of the step's tracks and relative pose, relative, given the
  program's previous scale;
- ``chain_gap``: the largest difference between the program's chained poses
  and the reference's float64 chaining of the program's relative poses and
  scales (rotation in rad plus translation relative to its size).

The control puts the reference in the program's place in bfloat16: its
pyramidal tracking from the same start points, its robust refinement from
the program's pose, its scale chaining and its pose chaining.

With ``MEATMODELER_SYNC_STAGES`` set, the calls of each step are timed with
the device synchronised around them, as the pipeline's stages are.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from portbench.frozen import so3
from portbench.frozen.scene import TurntableScene, render_sequence
from portbench.options import build_config, merge
from portbench.patches import Patches
from portbench.reference import enhance, track

__all__ = ["Runner"]

# The calls of an odometry step timed in a synced run, by stage.
STAGES = {"clahe": "track", "build_pyramid": "track", "lucas_kanade": "track", "estimate_relative_pose": "relpose"}


class Clip(NamedTuple):
    seed: int
    frames: np.ndarray  # (T, H, W) uint8 on the host
    poses: np.ndarray  # (T, 6) ground truth


@dataclasses.dataclass
class Record:
    clip: Clip
    result: object  # the program's OdometryResult
    tracks: list  # per step: (start points, point mask, tracked points, status)
    poses: list  # per step: (pts1, pts2, mask, K, rvec, tvec, inliers)
    timings: dict
    detail: dict = dataclasses.field(default_factory=dict)  # the check's per-step readings

    def release(self) -> None:
        """Drop what was kept for the check: a window's calls would
        otherwise hold some 10^5 small tensors alive, which slows the
        program's allocations and the collector as the window goes on."""
        self.tracks = self.poses = []


def _compose(pose_a, rvec_rel, tvec_rel, dtype):
    r_a = so3.exp(torch.as_tensor(pose_a[:3], dtype=dtype))
    r_rel = so3.exp(torch.as_tensor(rvec_rel, dtype=dtype))
    r_b = r_rel @ r_a
    t_b = r_rel @ torch.as_tensor(pose_a[3:], dtype=dtype) + torch.as_tensor(tvec_rel, dtype=dtype)
    return torch.cat([so3.log(r_b.double()).to(dtype), t_b])


class Runner:
    """One cell's clips and the calls the window makes on them."""

    def __init__(self, config: dict, traffic: dict, device):
        from meatmodeler_tpu_torch import config as config_mod
        from meatmodeler_tpu_torch import odometry
        from meatmodeler_tpu_torch.geometry import ransac
        from meatmodeler_tpu_torch.ops import clahe, klt

        self.device = torch.device(device)
        self.scene = TurntableScene(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["scene"].items()})
        self.num_frames = int(config["frames"])
        self.traffic = traffic
        self.options = merge(config["pipeline"], traffic.get("pipeline", {}))
        self.pipeline_config = build_config(config_mod.PipelineConfig, self.options)
        self._chain_poses = odometry.chain_poses
        self._step = {"tracks": [], "poses": [], "timings": {}}
        self._patches = Patches()
        for module, name, note in ((klt, "lucas_kanade", self._note_track), (ransac, "estimate_relative_pose",
                                   self._note_pose), (clahe, "clahe", None), (klt, "build_pyramid", None)):
            self._patches.replace(module, name, self._timed(STAGES[name], note))

    def _timed(self, stage, note):
        """A wrapper that times its call with the device synchronised around
        it when ``MEATMODELER_SYNC_STAGES`` is set, then notes it."""

        def make(real):
            def call(*args, **kwargs):
                synced = self.device.type == "cuda" and os.environ.get("MEATMODELER_SYNC_STAGES", "") not in ("", "0")
                if synced:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out = real(*args, **kwargs)
                if synced:
                    torch.cuda.synchronize()
                    timings = self._step["timings"]
                    timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0
                if note is not None:
                    note(args, kwargs, out)
                return out

            return call

        return make

    def _note_track(self, args, kwargs, flow):
        self._step["tracks"].append((args[2], kwargs.get("point_mask"), flow.points, flow.status))

    def _note_pose(self, args, kwargs, out):
        self._step["poses"].append(tuple(args[:4]) + (out[0], out[1], out[2].inliers))

    def close(self) -> None:
        self._patches.close()

    def inputs(self, seed: int) -> list:
        """The run's distinct grey clips: seeds ``seed * clips + i``."""
        n = int(self.traffic["clips"])
        out = []
        for i in range(n):
            clip_seed = (seed * n + i) % (1 << 63)
            frames, poses, _ = render_sequence(self.scene, self.num_frames, seed=clip_seed, color=False,
                                               device=self.device)
            out.append(Clip(clip_seed, frames, poses))
        return out

    def frames(self, clip: Clip) -> int:
        return len(clip.frames)

    def run(self, clip: Clip) -> Record:
        """The timed call: one ``chain_poses`` of the clip with the scene's K."""
        self._step = {"tracks": [], "poses": [], "timings": {}}
        result = self._chain_poses(clip.frames, self.scene.intrinsics, config=self.pipeline_config, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Record(clip, result, self._step["tracks"], self._step["poses"], self._step["timings"])

    def summarize(self, record: Record) -> dict:
        """What the per-layer numbers need of a call: its stage seconds."""
        return {"timings": record.timings}

    def end_to_end(self, summaries) -> dict:
        return {}

    def layer_rows(self, summaries) -> list:
        return [{"timings": s["timings"], "counters": {}} for s in summaries]

    # ---- the check -------------------------------------------------------

    def _enhanced(self, record: Record, dtype):
        clahe_cfg = self.options.get("clahe", {})
        return enhance.enhance(np.asarray(record.clip.frames), clahe_cfg.get("clip_limit", 3.5),
                               clahe_cfg.get("tile_grid", (8, 8)), self.device, dtype)

    def _batch(self, record: Record):
        """Every step's start points, point mask, tracked points and status
        as one batch, with each point's step."""
        starts, masks, tracked, status, step = [], [], [], [], []
        for t, (start, mask, pts, st) in enumerate(record.tracks):
            dev = start.device
            masks.append(torch.ones(start.shape[0], dtype=torch.bool, device=dev) if mask is None else mask.to(dev))
            starts.append(start)
            tracked.append(pts.to(dev))
            status.append(st.to(dev))
            step.append(torch.full((start.shape[0],), t, dtype=torch.long, device=dev))
        return (torch.cat(starts).double(), torch.cat(masks), torch.cat(tracked).double(), torch.cat(status),
                torch.cat(step))

    def _track_step(self, record: Record, greys, tracked, ok, mask, start, step) -> tuple:
        """The worst step's 90th percentile of the update at ``tracked`` over
        the points the reference or ``ok`` tracks (see the module's
        docstring), and the per-step readings."""
        kf = self.options["keyframe"]
        win, levels = int(kf["window"]), int(kf["pyramid_levels"])
        pyr = track.pyramid(greys.double(), levels)
        _, ref_ok = track.track([p[:-1] for p in pyr], [p[1:] for p in pyr], start, win, int(kf["max_iters"]),
                                float(kf["eps"]), step)
        ref_ok &= mask
        ok = ok & mask
        update = track.lk_update(greys[:-1], greys[1:], start, tracked, win, step)
        value = torch.where(ok, update, torch.full_like(update, math.inf))
        judged = ref_ok | ok
        worst, lost = 0.0, 0
        for t in range(len(record.tracks)):
            vals = torch.sort(value[judged & (step == t)]).values
            lost += int((ref_ok & ~ok & (step == t)).sum())
            if vals.numel():
                worst = max(worst, float(vals[max(math.ceil(0.9 * vals.numel()) - 1, 0)]))
        finite = update[ok]
        return worst, {"lost_points": lost, "judged_points": int(judged.sum()),
                       "update_p50": float(finite.median()) if finite.numel() else None,
                       "update_max": float(finite.max()) if finite.numel() else None}

    @staticmethod
    def _host_poses(record: Record) -> list:
        """The steps' pairs, masks, K, poses and inliers on the host: each
        step's problem is a few hundred numbers, which the CPU solves
        without a launch or a wait a step."""
        return [tuple(x.cpu() for x in step) for step in record.poses]

    def _pose_gain(self, record: Record, pose_by) -> tuple:
        gains = []
        for t, (pts1, pts2, mask, k, rvec, tvec, _) in enumerate(self._host_poses(record)):
            if int(mask.sum()) >= 8:
                rv, tv = pose_by(t, pts1[mask], pts2[mask], k, rvec, tvec)
                gains.append(track.pose_gain(rv, tv, pts1[mask], pts2[mask], k))
        if not gains:
            return math.inf, math.inf, {}
        ranked = np.sort(gains)
        return (float(np.median(ranked)), float(ranked[max(math.ceil(0.9 * len(ranked)) - 1, 0)]),
                {"pose_gain_worst": float(ranked[-1])})

    def _scales(self, record: Record, dtype) -> list:
        """The reference's scale chaining in ``dtype`` over the steps'
        tracks and relative poses, carrying its own scales."""
        scales, prev_depth, prev_scale = [], None, 1.0
        for t, (pts1, pts2, _, k, rvec, tvec, inl) in enumerate(self._host_poses(record)):
            if prev_depth is None:
                prev_depth = torch.full((pts1.shape[0],), math.nan, dtype=torch.float64)
            rot = so3.exp(rvec.double())
            scale, depth = track.depth_scale(k, rot, tvec, pts1, pts2, inl, prev_depth, prev_scale, dtype)
            scales.append(scale)
            prev_depth, prev_scale = self._carried(record, t, depth.double() * scale), scale
        return scales

    @staticmethod
    def _carried(record: Record, t: int, depth):
        """The depths the next step starts from: NaN where the tracker was
        seeded anew after step ``t``."""
        if t + 1 < len(record.tracks) and record.tracks[t + 1][0] is not record.tracks[t][2]:
            return torch.full_like(depth, math.nan)
        return depth

    def _scale_gap(self, record: Record, scales) -> float:
        """The worst step's ``scales[t]`` against the reference's float64
        scale given ``scales[t - 1]``, relative."""
        worst, prev_depth = 0.0, None
        for t, (pts1, pts2, _, k, rvec, tvec, inl) in enumerate(self._host_poses(record)):
            if prev_depth is None:
                prev_depth = torch.full((pts1.shape[0],), math.nan, dtype=torch.float64)
            prev_scale = scales[t - 1] if t > 0 else 1.0
            rot = so3.exp(rvec.double())
            ref, depth = track.depth_scale(k, rot, tvec, pts1, pts2, inl, prev_depth, prev_scale, torch.float64)
            got = float(scales[t])
            gap = abs(got - ref) / max(abs(ref), 1e-300)
            worst = max(worst, gap if gap == gap else math.inf)
            prev_depth = self._carried(record, t, depth * got)
        return worst

    def _chain(self, record: Record, dtype, scales) -> np.ndarray:
        """The reference's chaining, in ``dtype``, of the program's relative
        poses and ``scales``."""
        pose = torch.zeros(6, dtype=dtype)
        out = [pose]
        for t, (*_, rvec, tvec, _) in enumerate(record.poses):
            pose = _compose(pose, rvec.cpu().to(dtype), tvec.cpu().to(dtype) * float(scales[t]), dtype)
            out.append(pose)
        return torch.stack(out).double().numpy()

    @staticmethod
    def _pose_gap(got, ref) -> float:
        got = np.asarray(got, np.float64)
        if got.shape != ref.shape:
            return math.inf
        t_size = max(float(np.abs(ref[:, 3:]).max()), 1e-12)
        return float(np.abs(got[:, :3] - ref[:, :3]).max() + np.abs(got[:, 3:] - ref[:, 3:]).max() / t_size)

    def _complete(self, record: Record) -> bool:
        steps = len(record.clip.frames) - 1
        return len(record.tracks) == steps and len(record.poses) == steps

    def numbers(self, record: Record) -> dict:
        """The program's numbers on one clip (see the module's docstring)."""
        if not self._complete(record):
            return {"track_step_px": math.inf, "pose_gain": math.inf, "pose_gain_p90": math.inf,
                    "scale_gap": math.inf, "chain_gap": math.inf}
        res = record.result
        start, mask, tracked, status, step = self._batch(record)
        counted = torch.bincount(step[status & mask], minlength=len(record.tracks)).cpu().numpy()
        reported = np.asarray(res.num_tracked)[1:]
        track_step, detail = self._track_step(record, self._enhanced(record, torch.float32), tracked, status, mask,
                                              start, step)
        if reported.shape != counted.shape or not np.array_equal(reported, counted):
            track_step = math.inf
        pose_gain, pose_p90, pose_detail = self._pose_gain(record, lambda t, p1, p2, k, rv, tv: (rv, tv))
        scales = [float(s) for s in np.asarray(res.scales)[1:]]
        record.detail = dict(detail, **pose_detail, count_mismatch=int(np.sum(reported != counted))
                             if reported.shape == counted.shape else -1)
        return {
            "track_step_px": track_step,
            "pose_gain": pose_gain,
            "pose_gain_p90": pose_p90,
            "scale_gap": self._scale_gap(record, scales),
            "chain_gap": self._pose_gap(res.poses, self._chain(record, torch.float64, scales)),
        }

    def control_numbers(self, record: Record) -> dict:
        """The same numbers with the reference put in the program's place,
        computed in bfloat16."""
        greys = self._enhanced(record, torch.bfloat16)
        kf = self.options["keyframe"]
        start, mask, _, _, step = self._batch(record)
        pyr = track.pyramid(greys, int(kf["pyramid_levels"]))
        tracked, ok = track.track([p[:-1] for p in pyr], [p[1:] for p in pyr], start, int(kf["window"]),
                                  int(kf["max_iters"]), float(kf["eps"]), step)
        track_step, _ = self._track_step(record, self._enhanced(record, torch.float32), tracked.double(), ok, mask,
                                         start, step)

        def pose_by(t, p1, p2, k, rv, tv):
            return track.refine_pose(rv, tv, p1, p2, k, torch.bfloat16)

        scales = self._scales(record, torch.bfloat16)
        program_scales = [float(s) for s in np.asarray(record.result.scales)[1:]]
        pose_gain, pose_p90, _ = self._pose_gain(record, pose_by)
        return {"track_step_px": track_step, "pose_gain": pose_gain, "pose_gain_p90": pose_p90,
                "scale_gap": self._scale_gap(record, scales),
                "chain_gap": self._pose_gap(self._chain(record, torch.bfloat16, program_scales),
                                            self._chain(record, torch.float64, program_scales))}

    def diagnostics(self, record: Record) -> dict:
        from portbench.frozen.accuracy import odometry_accuracy

        res = record.result
        acc = odometry_accuracy(res.poses, res.num_tracked, record.clip.poses)
        return {"rot_err_first_deg": acc["rot_err_first_deg"], "drift_deg": acc["drift_deg"],
                "min_tracked": acc["min_tracked"], **record.detail}
