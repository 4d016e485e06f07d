"""Arithmetic of the per-layer readers that read the program's nested spans
(``portbench/metrics/idle_s.*``, ``host_reads.*``).

The program names each span by its path, ``<top-level stage>/<child>/...``;
a layer is a set of top-level stages, the heads of the paths it owns. The
traced window names each idle gap by its innermost range, which is a span's
path where the program opened one, and the synced window's counters hold
``host_reads:<path>``, one for each synchronizing operation in that span. A
program without nested spans still names its gaps by the top-level stages,
and counts no host reads: there the idle readers read the same gaps, and the
host-read readers read nothing.
"""

from __future__ import annotations

from typing import Iterable, Optional

__all__ = ["head", "idle_per_call", "host_reads_per_call"]

HOST_READS = "host_reads:"


def head(path: str) -> str:
    """The top-level stage of a span's path."""
    return path.split("/", 1)[0]


def idle_per_call(ctx, heads: Iterable[str]) -> Optional[float]:
    """Idle seconds of the traced window under the spans whose path's head is
    in ``heads``, over the traced calls; None where no gap falls under one."""
    heads = set(heads)
    idle = [s for name, s in ctx["trace"]["idle_s"].items() if head(name) in heads]
    return sum(idle) / ctx["trace"]["calls"] if idle else None


def host_reads_per_call(ctx, heads: Iterable[str]) -> Optional[float]:
    """Synchronizing operations a call of the synced window makes in the
    spans whose path's head is in ``heads``, the mean over the calls whose
    counters hold any host read; None where none does."""
    heads = set(heads)
    sums = []
    for row in ctx["rows"]:
        reads = {k[len(HOST_READS):]: v for k, v in row["counters"].items() if k.startswith(HOST_READS)}
        if reads:
            sums.append(sum(v for path, v in reads.items() if head(path) in heads))
    return sum(sums) / len(sums) if sums else None
