"""Model configs and the arch registry (torch port of ``repro/configs``)."""
