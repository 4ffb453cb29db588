"""ROO core: masks, the HSTU layer, the ROO batch, sequence packing and
the request-level joiner (torch port of ``repro/core``)."""
