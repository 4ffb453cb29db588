"""Median duration of the program's ``engine.flush`` span
(``serve/engine.py``): one flush from bucket choice to the scores' copy to
the host, device work included."""
import statistics


def read(layer):
    d = [s["dur"] for s in layer.spans if s["name"] == "engine.flush"]
    return statistics.median(d) / 1e3 if d else None
