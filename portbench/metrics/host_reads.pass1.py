"""Synchronizing operations per video in pass 1's keyframe scan
(``pass1_keyframes``) and their child spans, in the synced window (the
program's ``host_reads:<path>`` counters)."""

from portbench.spans import host_reads_per_call

HEADS = ("pass1_keyframes",)


def read(ctx):
    return host_reads_per_call(ctx, HEADS)
