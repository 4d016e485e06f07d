"""Idle device seconds per video under pass 1's keyframe scan
(``pass1_keyframes``) and their child spans, in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("pass1_keyframes",)


def read(ctx):
    return idle_per_call(ctx, HEADS)
