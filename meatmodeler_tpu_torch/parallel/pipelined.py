"""Two-stage pipeline over a stream of videos (torch twin of
``meatmodeler_tpu/parallel/pipelined.py``).

  stage 1, ingest (device A): pass 1, board resolution, pass 2 and the
    geometry up to the global solve (``pipeline._reconstruct_to_ba``);
  stage 2, solve (device B): global BA, volume and PLY
    (``pipeline._solve_and_finish``).

While video i solves, video i+1 ingests: two host threads and a bounded
queue between them. On one GPU both stages share the device (A = B) and the
overlap is between one stage's host work and the other's device work.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from meatmodeler_tpu_torch.pipeline import (
    ProcessResult,
    _check_supported,
    _make_device,
    _reconstruct_to_ba,
    _solve_and_finish,
    full_fp32,
)
from meatmodeler_tpu_torch.utils import Metrics
from meatmodeler_tpu_torch.utils.checkpoint import StageCheckpointer
from meatmodeler_tpu_torch.utils.numerics import load_cuda_linalg
from meatmodeler_tpu_torch.utils.profiling import profile_run

__all__ = ["process_batch_pipelined"]


def process_batch_pipelined(
    videos: Sequence,
    config: PipelineConfig = DEFAULT_CONFIG,
    devices: Optional[Sequence] = None,
    paths: Optional[Sequence[Optional[str]]] = None,
    known_corners: Optional[Sequence[Optional[np.ndarray]]] = None,
    queue_depth: int = 2,
) -> List[ProcessResult]:
    """Reconstruct a stream of videos with ingest and solve pipelined.

    Args:
      videos: video sources (paths or (T, H, W[, 3]) uint8 arrays).
      config: shared config tree (the rules of ``process`` apply).
      devices: (ingest, solve) devices. Defaults to ``cuda:0`` and the last
        CUDA device (the same one on a one-GPU machine); without CUDA it
        raises. ``("cpu", "cpu")`` runs on the CPU.
      paths: optional per-video output prefixes.
      known_corners: optional per-video ground-truth board corners.
      queue_depth: bound on the videos handed over and not yet solved.

    Returns:
      One ProcessResult per video, in input order. The first error of
      either stage is raised here.
    """
    n = len(videos)
    paths = list(paths) if paths is not None else [None] * n
    known_corners = list(known_corners) if known_corners is not None else [None] * n
    if devices is None:
        _make_device("cuda")
        devices = ("cuda:0", f"cuda:{torch.cuda.device_count() - 1}")
    d_ingest, d_solve = (_make_device(d) for d in devices)
    for k in known_corners:
        _check_supported(config, k)
    for d in (d_ingest, d_solve):
        load_cuda_linalg(d)

    metrics_list = [Metrics() for _ in range(n)]
    results: List[Optional[ProcessResult]] = [None] * n
    errors: List[BaseException] = []
    handoff: "queue.Queue" = queue.Queue(maxsize=queue_depth)

    def ingest_worker():
        try:
            for i, video in enumerate(videos):
                pre = _reconstruct_to_ba(
                    video, config, known_corners[i], metrics_list[i], StageCheckpointer(None), d_ingest
                )
                handoff.put((i, pre))
        except BaseException as e:  # re-raised on the caller's thread
            errors.append(e)
        finally:
            handoff.put(None)

    def solve_worker():
        try:
            with torch.no_grad():  # grad mode is per thread
                while True:
                    item = handoff.get()
                    if item is None:
                        return
                    i, pre = item
                    # Every tensor of the problem to the solve device (a
                    # copy across devices waits for the ingest stream).
                    pre = pre._replace(**{
                        k: v.to(d_solve) for k, v in pre._asdict().items() if isinstance(v, torch.Tensor)
                    })
                    results[i] = _solve_and_finish(pre, config, metrics_list[i], StageCheckpointer(None), paths[i])
        except BaseException as e:
            errors.append(e)
            # Keep draining so the ingest side never blocks on a full queue
            # after this stage has died; the remaining videos are dropped.
            while handoff.get() is not None:
                pass

    with profile_run(), full_fp32(), torch.no_grad():
        t_solve = threading.Thread(target=solve_worker)
        t_solve.start()
        ingest_worker()
        t_solve.join()
    if errors:
        raise errors[0]
    return results
