"""Model zoo (torch port of ``repro/models``): MLP, GR ranking, LSR, DLRM
and the DCNv2 and dot interactions so far."""
