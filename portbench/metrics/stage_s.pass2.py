"""Seconds per video in pass 2: enhance, ORB, matching and tracks."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("pass2_preprocess", "pass2_orb", "pass2_matching", "pass2_tracks"))
