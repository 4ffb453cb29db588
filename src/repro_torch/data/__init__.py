"""Jagged tensors, event simulation and the ROO batcher (torch port of
``repro/data``)."""
