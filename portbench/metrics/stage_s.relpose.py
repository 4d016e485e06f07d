"""Seconds per video inside ``ransac.estimate_relative_pose`` (the
odometry's relative poses), each call timed with the device synchronised
around it."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("relpose",))
