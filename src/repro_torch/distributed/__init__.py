"""SPMD training over a device mesh: the plan, the state and batch
placement, the explicit collectives and the compressed exchange."""
