"""Idle device seconds per video under the board geometry (``corner_refine``,
``calibration``, ``pose_estimation``, ``pose_ba``) and their child spans, in
the traced window."""

from portbench.spans import idle_per_call

HEADS = ("corner_refine", "calibration", "pose_estimation", "pose_ba")


def read(ctx):
    return idle_per_call(ctx, HEADS)
