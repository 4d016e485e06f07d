"""Share of the traced window in which no kernel, copy or memset ran on the
device, in percent (a ceiling: the profiler slows the host)."""


def read(ctx):
    trace = ctx["trace"]
    if trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
