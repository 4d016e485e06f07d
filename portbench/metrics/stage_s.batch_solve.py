"""Seconds per batch in the batched solve (``batch_solve``): padding and
stacking the videos' problems, the lane-batched Levenberg-Marquardt, and
the reads of the lanes' RMSE and iterations."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("batch_solve",))
