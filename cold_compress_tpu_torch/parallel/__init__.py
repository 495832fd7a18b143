"""Tensor and data parallelism of the port: one process per rank, weights,
caches and heads split over a (dp, tp) rank layout, collectives through
``torch.distributed`` (NCCL on cards, gloo on the CPU).

Counterpart of ``cold_compress_tpu/parallel/`` (``mesh.py`` and
``tp_decode.py``; sequence and pipeline parallelism are not ported yet)."""
