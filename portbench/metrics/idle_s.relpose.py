"""Idle device seconds per video under the odometry's relative pose
(``odometry_relpose``) and their child spans, in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("odometry_relpose",)


def read(ctx):
    return idle_per_call(ctx, HEADS)
