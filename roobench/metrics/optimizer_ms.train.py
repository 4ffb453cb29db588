"""The card's time of a training step's update: the median over the
window's ``train.step`` spans of the ``device_ms`` of the
``train.optimizer`` span inside each (``train/loop.py``: the guard's
norm, the optimizer's update and the guard)."""
from roobench.harness import load_reader


def read(layer):
    return load_reader("forward_ms.train").phase_ms(layer.spans,
                                                    "train.optimizer")
