"""Share of the batched LM's lane-iterations that went to lanes still
running, in percent: 100 x the iterations summed over the lanes each ran
(``lane_iterations:batch_solve``) over the lanes (``lanes:batch_solve``)
times the loop's iterations (``lm_iterations:batch_solve``), summed over the
synced window's calls. The rest stepped lanes that had already stopped."""

KEYS = ("lane_iterations:batch_solve", "lanes:batch_solve", "lm_iterations:batch_solve")


def read(ctx):
    rows = [r["counters"] for r in ctx["rows"] if all(k in r["counters"] for k in KEYS)]
    slots = sum(c["lanes:batch_solve"] * c["lm_iterations:batch_solve"] for c in rows)
    if slots <= 0:
        return None
    return 100.0 * sum(c["lane_iterations:batch_solve"] for c in rows) / slots
