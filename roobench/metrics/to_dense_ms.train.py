"""The card's time of a training step's sparse-row merges: the median over
the window's ``train.step`` spans of the summed ``device_ms`` of the
``sparse.to_dense`` spans inside each (``embeddings/sparse.py``, one a
table's COO gradient, whichever route or kernel sums it)."""
from roobench.harness import load_reader


def read(layer):
    return load_reader("forward_ms.train").phase_ms(layer.spans,
                                                    "sparse.to_dense")
