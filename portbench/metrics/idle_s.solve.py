"""Idle device seconds per video under the solver (``triangulation``,
``bundle_adjustment``) and their child spans, in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("triangulation", "bundle_adjustment")


def read(ctx):
    return idle_per_call(ctx, HEADS)
