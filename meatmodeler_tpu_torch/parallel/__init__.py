"""Multi-video entry points on one CUDA device: ``batch.process_batch``
(every video's BA in one batched solve) and
``pipelined.process_batch_pipelined`` (ingest and solve on two threads)."""
