"""Seconds per video in the odometry's tracking: CLAHE, the pyramids and
Lucas-Kanade, each call timed with the device synchronised around it."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("track",))
