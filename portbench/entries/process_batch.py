"""Runs ``meatmodeler_tpu_torch.parallel.batch.process_batch``: several
videos in one call, each reconstructed on its own up to its bundle
adjustment, the adjustments solved as one lane-batched Levenberg-Marquardt,
then a volume per video.

The configuration file gives the scene, the clip length, the videos a call
(``videos``) and the program's ``PipelineConfig`` as data; the traffic file
how many distinct batches a run sends in turn (``batches``; clip ``i`` of
the run has the seed ``seed * batches * videos + i``), whether the corners
go with the videos and the options it sets. Clips are rendered on the card
by the frozen renderer and kept on the host as uint8 arrays.

The check is the one of ``process.py``, over every video of a sampled call:
each number is the worst over the call's videos. What a video's stages were
given and gave back is kept under that video, not under the stage's name
alone: the per-video calls of the batch (``_pass2_to_preba``,
``_reconstruct_to_ba``, ``_volume_of``) are found by the video's own
``Metrics``, which the batch hands its prepass in video order, and a
thread-local video index is set around each, so the stage captures of the
two worker threads land under their own video. The global bundle
adjustment's problem is the video's own ``PreBA`` (its observations,
weights, K and starting cameras and points), so result ``i`` is judged
against video ``i``'s observations, not against lane ``i`` of the stacked
problem: results swapped or lanes misstacked read unbounded.

The control is ``process.py``'s, per video; a call's control reading is the
smallest over its videos.
"""

from __future__ import annotations

import math
import sys
import threading
import traceback
from pathlib import Path
from typing import List, NamedTuple

import torch

from portbench import spec
from portbench.frozen.scene import render_sequence

_process = spec.load_module(Path(__file__).with_name("process.py"), "portbench_entry_process")
Clip = _process.Clip

__all__ = ["Batch", "Record", "Runner"]


class Batch(NamedTuple):
    seed: int  # the first clip's seed
    clips: List[Clip]


class Record:
    """One call: the batch, its results in video order, and per video what
    its stages were given and gave back."""

    def __init__(self, clip: Batch, results: list, lanes: list):
        self.clip, self.results, self.lanes = clip, results, lanes

    def release(self) -> None:
        self.lanes = []

    def videos(self) -> list:
        """One ``process.py`` record a video, its global bundle adjustment's
        problem (``adjust_points``) formed from the video's ``PreBA``."""
        out = []
        for clip, result, cap in zip(self.clip.clips, self.results, self.lanes):
            cap = dict(cap)
            pre = cap.pop("preba", None)
            if pre is not None:
                cap["adjust_points"] = ((pre.ext_refined, pre.intrinsics, pre.points, pre.obs, pre.fidx, pre.pidx),
                                        {"weights": pre.obs_weight}, None)
            out.append(_process.Record(clip, result, cap))
        return out


class Runner(_process.Runner):
    """One cell's batches and the calls the window makes on them."""

    def __init__(self, config: dict, traffic: dict, device):
        from meatmodeler_tpu_torch.parallel import batch

        self._local = threading.local()
        self._lanes, self._metrics = [], []
        super().__init__(config, traffic, device)
        self.videos = int(config["videos"])
        self._process_batch = batch.process_batch
        self._patches.after(batch, "_batch_prepass", self._note_metrics)
        for name, position in (("_pass2_to_preba", 1), ("_reconstruct_to_ba", 3), ("_volume_of", 4)):
            self._patches.replace(batch, name, self._per_video(name, position))

    def _capturer(self, name):
        """Keeps a stage's last arguments and result under the video whose
        call runs on this thread."""

        def note(args, kwargs, out):
            i = getattr(self._local, "video", None)
            if i is not None:
                self._lanes[i][name] = (args, kwargs, out)

        return note

    def _note_metrics(self, args, kwargs, out):
        """The batch's per-video ``Metrics``, in video order."""
        self._metrics = list(args[3] if len(args) > 3 else kwargs["metrics_list"])

    def _per_video(self, name, position):
        """Sets this thread's video index around a per-video call (its
        ``Metrics`` is argument ``position``) and keeps the ``PreBA`` it
        returns."""

        def make(real):
            def call(*args, **kwargs):
                metrics = args[position]
                i = next((k for k, m in enumerate(self._metrics) if m is metrics), None)
                self._local.video = i
                try:
                    out = real(*args, **kwargs)
                finally:
                    self._local.video = None
                if i is not None and name != "_volume_of":
                    self._lanes[i]["preba"] = out
                return out

            return call

        return make

    def inputs(self, seed: int) -> list:
        """The run's distinct batches: ``batches`` of ``videos`` clips, clip
        ``i`` rendered with the seed ``seed * batches * videos + i``, on the
        card."""
        n_batches = int(self.traffic["batches"])
        n = n_batches * self.videos
        out = []
        for b in range(n_batches):
            clips = []
            for i in range(b * self.videos, (b + 1) * self.videos):
                clip_seed = (seed * n + i) % (1 << 63)
                frames, poses, corners = render_sequence(
                    self.scene, self.num_frames, seed=clip_seed, color=self.color, device=self.device
                )
                clips.append(Clip(clip_seed, frames, poses, corners if self.traffic.get("corners") == "known" else None))
            out.append(Batch(clips[0].seed, clips))
        return out

    def frames(self, clip: Batch) -> int:
        return sum(len(c.frames) for c in clip.clips)

    def run(self, clip: Batch) -> Record:
        """The timed call: one ``process_batch`` of the batch's videos, up
        to their host results."""
        self._lanes = [{} for _ in clip.clips]
        self._metrics = []
        known = None if self.traffic.get("corners") != "known" else [c.corners for c in clip.clips]
        results = self._process_batch([c.frames for c in clip.clips], config=self.pipeline_config,
                                      known_corners=known, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Record(clip, results, self._lanes)

    def summarize(self, record: Record) -> dict:
        """The batch's own timings and counters (``metrics["batch"]``, the
        same dict in every result), read once a call; empty where the
        program reports none."""
        batch = record.results[0].metrics.get("batch", {}) if record.results else {}
        return {"timings": dict(batch.get("timings", {})), "counters": dict(batch.get("counters", {}))}

    def end_to_end(self, summaries) -> dict:
        """Nothing besides the rate and the set-up."""
        return {}

    def layer_rows(self, summaries) -> list:
        """Per call: the batch's span seconds and counters."""
        return list(summaries)

    # ---- the check -------------------------------------------------------

    def _video_numbers(self, video: "_process.Record") -> dict:
        """``process.py``'s numbers of one video; unbounded where the
        returned cameras or points do not fit the video's own problem, or
        where judging raised."""
        try:
            pre = video.captured.get("adjust_points")
            out = super().numbers(video)
        except Exception:
            print(f"judging clip seed {video.clip.seed} raised:\n{traceback.format_exc()}", file=sys.stderr)
            return {name: math.inf for name in ("keyframes_gap", "corner_step_px", "board_gain", "rmse_gap",
                                                 "ba_gain")}
        if pre is not None:
            ext0, _, pts0 = pre[0][:3]
            if len(video.result.extrinsics) != len(ext0) or len(video.result.points) != len(pts0):
                out.update(rmse_gap=math.inf, ba_gain=math.inf)
        return out

    def numbers(self, record: Record) -> dict:
        """Each number's worst over the call's videos."""
        per = [self._video_numbers(v) for v in record.videos()]
        return {name: max(p[name] for p in per) for name in per[0]}

    def control_numbers(self, record: Record) -> dict:
        """The control's numbers, each the smallest over the call's videos."""
        judge = super().control_numbers
        per = [judge(v) for v in record.videos()]
        return {name: min(p[name] for p in per) for name in per[0]}

    def diagnostics(self, record: Record) -> dict:
        """``process.py``'s diagnostics a video, in video order, with each
        lane's LM iterations (what raised where a result does not fit its
        video)."""
        out = []
        for v in record.videos():
            try:
                out.append(dict(super().diagnostics(v),
                                ba_iterations=v.result.metrics["counters"].get("ba_iterations")))
            except Exception as exc:
                out.append({"error": repr(exc)[:200]})
        return {"videos": out}
