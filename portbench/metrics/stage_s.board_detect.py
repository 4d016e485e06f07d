"""Seconds per video in the device board detection (``board_detect``)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("board_detect",))
