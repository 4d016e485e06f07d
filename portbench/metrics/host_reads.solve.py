"""Synchronizing operations per video in the solver (``triangulation``,
``bundle_adjustment``) and their child spans, in the synced window (the
program's ``host_reads:<path>`` counters)."""

from portbench.spans import host_reads_per_call

HEADS = ("triangulation", "bundle_adjustment")


def read(ctx):
    return host_reads_per_call(ctx, HEADS)
