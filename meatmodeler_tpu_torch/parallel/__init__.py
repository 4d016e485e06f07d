"""Multi-video and multi-device entry points: ``batch.process_batch`` (every
video's BA in one batched solve, over a mesh of GPUs when given one),
``pipelined.process_batch_pipelined`` (ingest and solve on two threads) and
``sharded`` (the device mesh, point-sharded BA, tensor-parallel matching,
sharded preprocessing)."""

from meatmodeler_tpu_torch.parallel.sharded import (  # noqa: F401
    make_mesh,
    match_descriptors_tp,
    preprocess_sharded,
    solve_ba_batch,
)
