"""Model zoo (torch port of ``repro/models``): MLP, GR ranking, LSR and
the DCNv2 interaction so far."""
