"""Requests a batch holds as a share of the policy's ``max_requests``:
``EngineStats`` requests over batches times the policy's limit."""


def read(layer):
    c = layer.counts
    if not c.get("batches"):
        return None
    return 100.0 * c["fill_requests"] / (c["batches"] * c["max_requests"])
