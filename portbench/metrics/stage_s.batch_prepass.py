"""Seconds per batch in the batch's prepass (``batch_prepass``): each clip's
host C++ keyframe scan, then the device board detector on its keyframes."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("batch_prepass",))
