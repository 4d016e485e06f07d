"""Idle device seconds per batch under the worker pool (``batch_pool``) and
the per-video stages its workers open, in the traced window. A gap takes
the innermost range of either thread, so the pool's idle is read by these
heads together, never by video. (Where the profiler is not enabled on the
worker threads, as with torch 2.11, their spans are no ranges and every gap
of the pool reads as ``batch_pool``.)"""

from portbench.spans import idle_per_call

HEADS = ("batch_pool", "pass2_preprocess", "pass2_orb", "pass2_matching", "pass2_tracks", "corner_refine",
         "calibration", "pose_estimation", "pose_ba", "pose_chain", "triangulation")


def read(ctx):
    return idle_per_call(ctx, HEADS)
