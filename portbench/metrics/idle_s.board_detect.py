"""Idle device seconds per video under the board detection (``board_detect``)
and their child spans, in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("board_detect",)


def read(ctx):
    return idle_per_call(ctx, HEADS)
