"""Seconds per video in pass 1: the keyframe scan (``pass1_keyframes``)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("pass1_keyframes",))
