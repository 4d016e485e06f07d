"""Seconds per video in the volume (``volume``)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("volume",))
