"""Idle device seconds per video under pass 2 (``pass2_preprocess``,
``pass2_orb``, ``pass2_matching``, ``pass2_tracks``) and their child spans,
in the traced window."""

from portbench.spans import idle_per_call

HEADS = ("pass2_preprocess", "pass2_orb", "pass2_matching", "pass2_tracks")


def read(ctx):
    return idle_per_call(ctx, HEADS)
