"""The card's time of a training step's backward: the median over the
window's ``train.step`` spans of the summed ``device_ms`` of the
``train.backward`` spans inside each (``train/loop.py`` and
``embeddings/sparse.py``, one a microbatch)."""
from roobench.harness import load_reader


def read(layer):
    return load_reader("forward_ms.train").phase_ms(layer.spans,
                                                    "train.backward")
