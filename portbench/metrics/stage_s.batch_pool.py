"""Seconds per batch in the batch's worker pool (``batch_pool``): pass 2 and
the board geometry of every video on two worker threads. In the synced
window every span's exit barrier serialises the two workers, so this is the
pool's work without their overlap."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("batch_pool",))
