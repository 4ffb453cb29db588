"""The LM family (torch port of ``repro/models/lm``)."""
