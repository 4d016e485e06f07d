"""Idle device seconds per video under the odometry's tracking
(``odometry_enhance``, ``odometry_pyramid``, ``odometry_lk``) and their
child spans, in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("odometry_enhance", "odometry_pyramid", "odometry_lk")


def read(ctx):
    return idle_per_call(ctx, HEADS)
