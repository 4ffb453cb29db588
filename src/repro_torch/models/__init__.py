"""Model zoo (torch port of ``repro/models``): MLP and GR ranking so far."""
