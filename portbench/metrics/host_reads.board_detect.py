"""Synchronizing operations per video in the board detection (``board_detect``)
and their child spans, in the synced window (the program's
``host_reads:<path>`` counters)."""

from portbench.spans import host_reads_per_call

HEADS = ("board_detect",)


def read(ctx):
    return host_reads_per_call(ctx, HEADS)
