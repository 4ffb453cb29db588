"""Model configs (torch port of ``repro/configs``): hstu-gr so far."""
