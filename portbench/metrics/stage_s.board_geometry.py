"""Seconds per video in the board geometry: corner refinement, calibration,
PnP and the pose-only bundle adjustment."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("corner_refine", "calibration", "pose_estimation", "pose_ba"))
