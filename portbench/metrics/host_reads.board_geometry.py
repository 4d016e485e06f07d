"""Synchronizing operations per video in the board geometry (``corner_refine``,
``calibration``, ``pose_estimation``, ``pose_ba``) and their child spans, in
the synced window (the program's ``host_reads:<path>`` counters)."""

from portbench.spans import host_reads_per_call

HEADS = ("corner_refine", "calibration", "pose_estimation", "pose_ba")


def read(ctx):
    return host_reads_per_call(ctx, HEADS)
