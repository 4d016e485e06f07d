"""Synchronizing operations per video in pass 2 (``pass2_preprocess``,
``pass2_orb``, ``pass2_matching``, ``pass2_tracks``) and their child spans,
in the synced window (the program's ``host_reads:<path>`` counters)."""

from portbench.spans import host_reads_per_call

HEADS = ("pass2_preprocess", "pass2_orb", "pass2_matching", "pass2_tracks")


def read(ctx):
    return host_reads_per_call(ctx, HEADS)
