"""Runs ``meatmodeler_tpu_torch.pipeline.process``: one video in, a
bundle-adjusted cloud and a volume out.

The configuration file gives the scene, the clip length and the program's
``PipelineConfig`` as data; the traffic file says whether the client sends
the board's corners with the video (``"corners": "known"``) and which
options of the program it sets (``"pipeline"``, merged over the
configuration's). Clips are rendered on the card by the frozen renderer and
kept on the host as uint8 arrays, as a decoded video would be, so the upload
is part of each call.

While a clip runs, the runner keeps references to what the program's stages
were given and gave back, to judge them after the window: the enhanced
keyframes that pass 2 hands its feature detector (``orb.detect_and_compute``),
the corners before and after sub-pixel refinement
(``chessboard.refine_corners_subpix``), the board poses before and after
pose refinement with the calibrated K (``bundle_adjust.adjust_pose``), the
global bundle adjustment's problem (the last ``bundle_adjust.adjust_points``)
and the volume stage's point gate and parameters
(``volume.split_item_points``, ``volume.hull_and_carved_volume``). The
numbers compared:

- ``keyframes_gap``: over the clip's keyframes, the largest mean absolute
  difference in grey levels between the program's enhanced keyframe and
  the reference's, formed from the raw frame at the keyframe index the
  program chose (``portbench/reference/enhance.py``);
- ``corner_step_px``: the longest step that one more float64 sub-pixel
  iteration of the reference takes from the program's refined corners, on
  the reference's enhanced keyframes (``portbench/reference/board.py``);
- ``board_gain``: the share of the board's reprojection cost at the
  program's focal length and refined board poses, over its refined corners,
  that one float64 step of the reference over the focal length and every
  pose removes (the principal point at the image centre, no distortion, as
  the configuration states);
- ``rmse_gap``: the program's reported reprojection RMSE against the
  reference's float64 RMSE of the program's returned cameras and points over
  the bundle adjustment's observations, relative;
- ``ba_gain``: the share of the bundle adjustment's cost at the program's
  returned cameras and points that one float64 Levenberg-Marquardt step of
  the reference still removes (``portbench/reference/ba.py``).

The volume is not among them: the program's reported volume against the
reference's float64 hull volume (``portbench/reference/volume.py``) reads
up to 0.8% on sound runs and as little as 0.07% with the reference in
bfloat16 in its place, so no limit separates the two. It is printed beside
the check (``volume_gap``, and ``volume_gap_given_mask`` with the program's
own item points, ``item_points_differ``), with the volume's error against
the scene's analytic volume.

The control puts the reference in the program's place in bfloat16: the
reference's enhanced keyframes, its sub-pixel refinement from the program's
unrefined corners, its focal length and pose refinement from the program's
unrefined poses and its own bundle adjustment from the program's starting
cameras and points, each computed in bfloat16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.frozen import so3
from portbench.frozen.accuracy import markerless_accuracy
from portbench.frozen.scene import TurntableScene, render_sequence
from portbench.options import build_config, merge
from portbench.patches import Patches
from portbench.reference import ba, board, enhance
from portbench.reference import volume as volume_ref

__all__ = ["Clip", "Record", "Runner"]


class Clip(NamedTuple):
    seed: int
    frames: np.ndarray  # (T, H, W[, 3]) uint8 on the host
    poses: np.ndarray  # (T, 6) ground truth
    corners: Optional[np.ndarray]  # (T, N, 2) sent with the video, or None


@dataclasses.dataclass
class Record:
    clip: Clip
    result: object  # the program's ProcessResult
    captured: dict  # what the program's stages were given and gave back (see the module's docstring)

    def release(self) -> None:
        """Drop what was kept for the check."""
        self.captured = {}


class Summary(NamedTuple):
    """What the end-to-end and per-layer numbers need of a call that is not
    checked, on the host: the returned cameras and points with the bundle
    adjustment's observations, the stage seconds and counters."""

    extrinsics: np.ndarray
    points: np.ndarray
    intrinsics: np.ndarray
    obs: np.ndarray
    fidx: np.ndarray
    pidx: np.ndarray
    timings: dict
    counters: dict


class Runner:
    """One cell's clips and the calls the window makes on them."""

    def __init__(self, config: dict, traffic: dict, device):
        from meatmodeler_tpu_torch import config as config_mod
        from meatmodeler_tpu_torch import pipeline
        from meatmodeler_tpu_torch import volume as volume_mod
        from meatmodeler_tpu_torch.ops import chessboard, orb
        from meatmodeler_tpu_torch.solvers import bundle_adjust

        self.device = torch.device(device)
        self.scene = TurntableScene(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["scene"].items()})
        self.num_frames = int(config["frames"])
        self.color = bool(config.get("color", True))
        self.traffic = traffic
        self.options = merge(config["pipeline"], traffic.get("pipeline", {}))
        self.pipeline_config = build_config(config_mod.PipelineConfig, self.options)
        self._process = pipeline.process
        self._captured = {}
        self._patches = Patches()
        for module, name in ((orb, "detect_and_compute"), (chessboard, "refine_corners_subpix"),
                             (bundle_adjust, "adjust_pose"), (bundle_adjust, "adjust_points"),
                             (volume_mod, "split_item_points"), (volume_mod, "hull_and_carved_volume")):
            self._patches.after(module, name, self._capturer(name))

    def _capturer(self, name):
        """Keeps a stage's last arguments and result, by reference."""

        def note(args, kwargs, out):
            self._captured[name] = (args, kwargs, out)

        return note

    @staticmethod
    def _ba_args(captured: dict):
        """(extrinsics, intrinsics, points, obs, fidx, pidx, weights) of the
        global bundle adjustment, or None."""
        if "adjust_points" not in captured:
            return None
        args, kwargs, _ = captured["adjust_points"]
        names = ("extrinsics", "intrinsics", "points_3d", "points_2d", "frame_indices", "point_indices", "mask",
                 "weights")
        bound = dict(zip(names, args), **kwargs)
        return tuple(bound.get(k) for k in names[:6]) + (bound.get("weights"),)

    def close(self) -> None:
        self._patches.close()

    def inputs(self, seed: int) -> list:
        """The run's distinct clips: ``clips`` renders with seeds
        ``seed * clips + i``, on the card."""
        n = int(self.traffic["clips"])
        out = []
        for i in range(n):
            clip_seed = (seed * n + i) % (1 << 63)
            frames, poses, corners = render_sequence(
                self.scene, self.num_frames, seed=clip_seed, color=self.color, device=self.device
            )
            out.append(Clip(clip_seed, frames, poses, corners if self.traffic.get("corners") == "known" else None))
        return out

    def frames(self, clip: Clip) -> int:
        return len(clip.frames)

    def run(self, clip: Clip) -> Record:
        """The timed call: one ``process`` of the clip, up to its host
        result."""
        self._captured = {}
        result = self._process(clip.frames, config=self.pipeline_config, known_corners=clip.corners, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Record(clip, result, self._captured)

    def summarize(self, record: Record) -> Summary:
        """The host copy of what the end-to-end and per-layer numbers need
        of a call (the call has synchronised: these copies wait on nothing)."""
        res, ba_args = record.result, self._ba_args(record.captured)
        obs, fidx, pidx = ((None,) * 3 if ba_args is None else
                           (ba_args[3].cpu().numpy(), np.asarray(ba_args[4].cpu()), np.asarray(ba_args[5].cpu())))
        return Summary(res.extrinsics, res.points, res.intrinsics, obs, fidx, pidx, res.metrics["timings"],
                       res.metrics["counters"])

    def end_to_end(self, summaries) -> dict:
        """The cell's end-to-end numbers besides the rate: the mean over
        every clip of the window of the reprojection RMSE that the reference
        computes, in float64, from the cameras and points the program
        returned over the bundle adjustment's observations (the program's
        own report is judged by ``rmse_gap``)."""
        values = []
        for s in summaries:
            if s.obs is None:
                values.append(math.inf)
                continue
            ext = torch.from_numpy(np.asarray(s.extrinsics, np.float64))
            values.append(float(ba.rmse({
                "R": ext[:, :3, :3], "t": ext[:, :3, 3],
                "points": torch.from_numpy(np.asarray(s.points, np.float64)).reshape(-1, 3),
                "K": torch.from_numpy(np.asarray(s.intrinsics, np.float64)),
                "obs": torch.from_numpy(np.asarray(s.obs, np.float64)).reshape(-1, 2),
                "fidx": torch.from_numpy(s.fidx).long(), "pidx": torch.from_numpy(s.pidx).long(),
                "weight": torch.ones(len(s.fidx), dtype=torch.float64)})))
        return {"rmse_px": float(np.mean(values))}

    def layer_rows(self, summaries) -> list:
        """Per clip: the program's stage seconds and counters."""
        return [{"timings": s.timings, "counters": s.counters} for s in summaries]

    # ---- the check -------------------------------------------------------

    def _reference_keyframes(self, record: Record, dtype) -> torch.Tensor:
        counters = record.result.metrics["counters"]
        scale = int(counters["kf_scale"])
        grey = self.options.get("pass2_enhance") == "grey"
        stack = np.stack([enhance.keyframe(record.clip.frames[i], scale, grey) for i in counters["keyframe_indices"]])
        clahe_cfg = self.options.get("clahe", {})
        return enhance.enhance(stack, clahe_cfg.get("clip_limit", 3.5), clahe_cfg.get("tile_grid", (8, 8)),
                               self.device, dtype)

    def _keyframes_gap(self, reference: torch.Tensor, program) -> float:
        if program is None or tuple(program.shape) != tuple(reference.shape):
            return math.inf
        gap = (program.to(torch.float64) - reference.to(torch.float64)).abs().mean(dim=(1, 2))
        return float(gap.max())

    def _corner_step(self, greys: torch.Tensor, corners) -> float:
        if corners is None or tuple(corners.shape[:1]) != tuple(greys.shape[:1]):
            return math.inf
        win = int(self.options["chessboard"]["subpix_window"])
        return float(board.subpix_step(greys, corners.to(greys.device), win).max())

    def _board_problem(self, record: Record, greys: torch.Tensor) -> Optional[dict]:
        """The board problem over the program's refined corners at the
        program's refined poses and focal length, in float64; None where a
        stage did not run."""
        cap = record.captured
        if "refine_corners_subpix" not in cap or "adjust_pose" not in cap:
            return None
        corners = cap["refine_corners_subpix"][2].to(torch.float64)
        args, kwargs, (ext, _) = cap["adjust_pose"]
        cb = self.options["chessboard"]
        h, w = greys.shape[1:]
        return {
            "R": ext[:, :3, :3].to(torch.float64), "t": ext[:, :3, 3].to(torch.float64),
            "focal": args[1][0, 0].to(torch.float64),
            "centre": torch.tensor([0.5 * w, 0.5 * h], dtype=torch.float64, device=corners.device),
            "board": board.board_points(cb["pattern"], float(cb["side_length"]), device=corners.device),
            "corners": corners,
        }

    def _volume_gaps(self, record: Record) -> dict:
        """The program's reported volume against the reference's float64
        hull volume of the program's returned points, cameras and K: with
        the reference's item points from the stage's point gate
        (``volume_gap``), and with the program's own item points
        (``volume_gap_given_mask``); and how many points the two item sets
        disagree on."""
        cap, res = record.captured, record.result
        if "split_item_points" not in cap or "hull_and_carved_volume" not in cap:
            return {}
        s_args, s_kwargs, program_items = cap["split_item_points"]
        _, h_kw, _ = cap["hull_and_carved_volume"]
        dev = s_args[0].device
        points = torch.from_numpy(np.asarray(res.points, np.float64)).to(dev)
        ext = torch.from_numpy(np.asarray(res.extrinsics, np.float64)).to(dev)
        k = torch.from_numpy(np.asarray(res.intrinsics, np.float64)).to(dev)
        items = volume_ref.item_mask(points, s_args[1].to(dev), use_plane=s_kwargs.get("use_plane", True))
        params = (h_kw["image_size"], h_kw["resolution"], h_kw["num_directions"], h_kw["trim"], h_kw["trim_ref"],
                  h_kw["dilation"], h_kw["grid_step"], h_kw["close_frac"], h_kw["vote_frac"], torch.float64)
        out = {"item_points_differ": int((items != program_items.to(dev)).sum())}
        for name, mask in (("volume_gap", items), ("volume_gap_given_mask", program_items.to(dev))):
            vol = volume_ref.hull_volume(points, mask, k @ ext[:, :3, :], *params)
            out[name] = abs(float(res.volume) - vol) / vol if vol > 0 else math.inf
        return out

    def _problem(self, record: Record, extrinsics, points) -> dict:
        """The global BA's problem at cameras ``extrinsics`` (F, 3|4, 4) and
        ``points``, in float64."""
        _, intrinsics, _, obs, fidx, pidx, weights = self._ba_args(record.captured)
        dev = obs.device
        ext = torch.as_tensor(np.asarray(extrinsics), dtype=torch.float64, device=dev)
        return {
            "R": ext[:, :3, :3],
            "t": ext[:, :3, 3],
            "points": torch.as_tensor(np.asarray(points), dtype=torch.float64, device=dev).reshape(-1, 3),
            "K": intrinsics.to(torch.float64),
            "obs": obs.reshape(-1, 2).to(torch.float64),
            "fidx": torch.as_tensor(fidx, device=dev).long(),
            "pidx": torch.as_tensor(pidx, device=dev).long(),
            "weight": (torch.ones(obs.shape[0], device=dev) if weights is None else weights).to(torch.float64),
        }

    def _ba_numbers(self, problem: dict, reported_rmse: float) -> dict:
        ref_rmse = float(ba.rmse(problem))
        return {"rmse_gap": abs(reported_rmse - ref_rmse) / ref_rmse, "ba_gain": ba.gain(problem)}

    def _returned(self, record: Record) -> dict:
        """The global BA's problem at the cameras and points the program
        returned."""
        return self._problem(record, record.result.extrinsics, record.result.points)

    def numbers(self, record: Record) -> dict:
        """The program's numbers on one clip (see the module's docstring)."""
        cap = record.captured
        greys = self._reference_keyframes(record, torch.float32)
        keyframes = cap["detect_and_compute"][0][0] if "detect_and_compute" in cap else None
        refined = cap["refine_corners_subpix"][2] if "refine_corners_subpix" in cap else None
        problem = self._board_problem(record, greys)
        out = {"keyframes_gap": self._keyframes_gap(greys, keyframes),
               "corner_step_px": self._corner_step(greys, refined),
               "board_gain": math.inf if problem is None else board.gain(problem)}
        if self._ba_args(cap) is None:
            out.update(rmse_gap=math.inf, ba_gain=math.inf)
        else:
            out.update(self._ba_numbers(self._returned(record), float(record.result.reprojection_rmse)))
        return out

    def control_numbers(self, record: Record) -> dict:
        """The same numbers with the reference put in the program's place,
        computed in bfloat16."""
        cap = record.captured
        greys = self._reference_keyframes(record, torch.float32)
        out = {"keyframes_gap": self._keyframes_gap(greys, self._reference_keyframes(record, torch.bfloat16))}
        cb = self.options["chessboard"]
        if "refine_corners_subpix" in cap:
            start = cap["refine_corners_subpix"][0][1]
            ctl = board.subpix(self._reference_keyframes(record, torch.bfloat16), start.to(greys.device),
                               int(cb["subpix_window"]), int(cb["subpix_iters"]), float(cb.get("subpix_eps", 1e-3)),
                               torch.bfloat16)
            out["corner_step_px"] = self._corner_step(greys, ctl.to(torch.float64))
        problem = self._board_problem(record, greys)
        if problem is not None:
            ext0 = cap["adjust_pose"][0][0]
            start = dict(problem, R=ext0[:, :3, :3].to(torch.float64), t=ext0[:, :3, 3].to(torch.float64))
            R, t, focal = board.solve(start, torch.bfloat16)
            out["board_gain"] = board.gain(dict(problem, R=R.double(), t=t.double(), focal=focal.double()))
        ext0, _, pts0 = self._ba_args(cap)[:3]
        start = self._problem(record, ext0.cpu(), pts0.cpu())
        solver = self.options.get("solver", {})
        R, t, points, rmse = ba.solve(start, torch.bfloat16, int(solver.get("max_iters", 50)),
                                      float(solver.get("ftol", 1e-4)), float(solver.get("init_lambda", 1e-3)))
        out.update(self._ba_numbers(dict(start, R=R.double(), t=t.double(), points=points.double()), float(rmse)))
        return out

    def diagnostics(self, record: Record) -> dict:
        """Accuracy against the renderer's truth, printed beside the check:
        on a board path the focal length, the refined board poses (the
        board's frame is the scene's) and the volume, with the volume's gaps
        to the reference (see the module's docstring); marker-free the
        aligned pose error."""
        res = record.result
        counters = res.metrics["counters"]
        out = {"keyframes": counters.get("keyframes"), "points": len(res.points),
               "rmse_px": float(res.reprojection_rmse)}
        if counters.get("markerless"):
            acc = markerless_accuracy(counters["keyframe_indices"], res.extrinsics, res.points, record.clip.poses,
                                      self.scene)
            out["aligned_pose_rmse_vs_ring"] = acc["aligned_pose_rmse_vs_ring"]
            return out
        out["volume_err"] = (res.volume - self.scene.volume) / self.scene.volume
        out.update(self._volume_gaps(record))
        scale = float(counters["kf_scale"])
        out["focal_err"] = float(res.intrinsics[0, 0]) * scale / float(self.scene.focal) - 1.0
        if "adjust_pose" in record.captured:
            ext = record.captured["adjust_pose"][2][0].detach().double().cpu()
            truth = torch.from_numpy(np.asarray(record.clip.poses, np.float64)[counters["keyframe_indices"]])
            r_true = so3.exp(truth[:, :3])
            cos = ((ext[:, :3, :3].transpose(1, 2) @ r_true).diagonal(dim1=1, dim2=2).sum(-1) - 1.0) / 2.0
            centre = -(ext[:, :3, :3].transpose(1, 2) @ ext[:, :3, 3:])[..., 0]
            centre_true = -(r_true.transpose(1, 2) @ truth[:, 3:, None])[..., 0]
            out["pose_rot_err_deg_max"] = float(torch.rad2deg(torch.arccos(cos.clamp(-1, 1))).max())
            out["pose_centre_err_max"] = float((centre - centre_true).norm(dim=1).max())
        return out
