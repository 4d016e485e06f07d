"""Idle device seconds per video under the odometry's scale chaining and
reseeding (``odometry_scale``, ``odometry_reseed``) and their child spans,
in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("odometry_scale", "odometry_reseed")


def read(ctx):
    return idle_per_call(ctx, HEADS)
