"""``parallel.pipelined.process_batch_pipelined`` of the port on the CPU
(``devices=("cpu", "cpu")``): the same results as the port's ``process``
one video after the other (the JAX package's own test holds its pipelined
schedule to its ``process`` the same way, ``test_pipelined.py``), the
first error of either stage raised on the caller's thread, and no deadlock
when the solve stage dies."""

import dataclasses

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch.parallel import pipelined as tpipelined
from meatmodeler_tpu_torch.pipeline import process
from test_torch_batch import TINY, TINY_SCENE, _clips

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clips():
    return _clips(TINY_SCENE, 10)


def test_pipelined_matches_sequential(clips):
    frames, corners = clips
    piped = tpipelined.process_batch_pipelined(frames, config=TINY, known_corners=corners, devices=("cpu", "cpu"))
    for v, c, res in zip(frames, corners, piped):
        seq = process(v, config=TINY, known_corners=c, device="cpu")
        np.testing.assert_array_equal(res.points, seq.points)
        assert res.reprojection_rmse == seq.reprojection_rmse
        assert res.metrics["counters"]["keyframe_indices"] == seq.metrics["counters"]["keyframe_indices"]


def test_pipelined_propagates_ingest_errors():
    """Noise frames: no board, and no marker-free bootstrap either; the
    ingest stage's error reaches the caller."""
    noise = np.random.default_rng(0).integers(0, 255, size=(10, 120, 160, 3), dtype=np.uint8)
    cfg = dataclasses.replace(
        TINY, pass1_backend="device", chessboard=dataclasses.replace(TINY.chessboard, detector="device")
    )
    with pytest.raises(ValueError, match="chessboard|marker-free"):
        tpipelined.process_batch_pipelined([noise], config=cfg, devices=("cpu", "cpu"))


def test_failing_solve_stage_does_not_deadlock(clips, monkeypatch):
    """A solve-stage failure re-raises on the caller's thread and the
    bounded queue keeps draining (three videos, queue depth 1)."""
    frames, corners = clips

    def boom(*args, **kwargs):
        raise RuntimeError("solver exploded")

    monkeypatch.setattr(tpipelined, "_solve_and_finish", boom)
    with pytest.raises(RuntimeError, match="solver exploded"):
        tpipelined.process_batch_pipelined(
            frames + frames[:1], config=TINY, known_corners=corners + corners[:1], devices=("cpu", "cpu"),
            queue_depth=1,
        )
