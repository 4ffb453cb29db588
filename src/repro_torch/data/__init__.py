"""Jagged tensors, event simulation, the ROO batcher and the shard codec
(torch port of ``repro/data``)."""
