"""Seconds per video in triangulation and the global bundle adjustment."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("triangulation", "bundle_adjustment"))
