"""Kernel launches in the traced window per call profiled."""


def read(ctx):
    trace = ctx["trace"]
    return trace["launches"] / trace["calls"] if trace["calls"] else None
