"""Tensor, data, sequence and pipeline parallelism of the port: one process
per rank, weights, caches, heads, query rows or layer stages split over a
rank layout, collectives through ``torch.distributed`` (NCCL on cards, gloo
on the CPU).

Counterpart of ``cold_compress_tpu/parallel/`` (``mesh.py``,
``tp_decode.py``, ``sp.py`` and ``pp.py``)."""
