"""Levenberg-Marquardt iterations of the global bundle adjustment per video."""

from portbench.readers import counter_mean


def read(ctx):
    return counter_mean(ctx, "ba_iterations")
