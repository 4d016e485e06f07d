"""Idle device seconds per batch under the batched solve (``batch_solve``)
and its child spans, in the traced window."""

from portbench.spans import idle_per_call


def read(ctx):
    return idle_per_call(ctx, ("batch_solve",))
