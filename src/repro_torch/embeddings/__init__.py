"""Embedding lookups (torch port of ``repro/embeddings``)."""
