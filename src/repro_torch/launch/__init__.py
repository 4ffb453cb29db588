"""Entry points (torch port of ``repro/launch``): the training launcher."""
