"""Share of the traced window in which nothing ran on the card."""


def read(layer):
    if layer.trace is None:
        return None
    return 100.0 * (1.0 - layer.trace.busy_s / layer.trace.window_s)
