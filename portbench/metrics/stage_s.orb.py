"""Seconds per video in ORB detection and description (``pass2_orb``)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("pass2_orb",))
