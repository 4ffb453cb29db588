"""repro_torch — the PyTorch + CUDA port of the ROO recommendation framework.

It mirrors the JAX package ``repro`` path for path (``repro/core/hstu.py``
becomes ``repro_torch/core/hstu.py``) and never imports ``jax`` or
``repro``: the parity tests are the only code that sees both.

Ported so far (hstu-gr serving: stateless, user-tower cache, incremental):
  scenario/knobs   the precedence ladder for runtime knobs
  core/            masks (incl. the cached-prefix spec), HSTU layer and its
                   prefix variant, ROO batch, sequence packing, joiner
  kernels/         hand-written CUDA HSTU forward and cached-prefix forward
                   + their plain torch versions
  data/            jagged tensors, event simulation, ROO batcher
  embeddings/      local lookups (seq / row / dedup gather)
  models/          MLP, GR ranking and its per-user state functions
  configs/         hstu-gr config
  serve/           bucketing, adapter, scoring engine (user-tower cache,
                   incremental state store), user_cache, ROOServer
  interop.py       carries parameter trees and user states from numpy

Entry points take an explicit ``device`` (default ``"cuda"``); the tests
pass ``device="cpu"``. The port is eager: there is no ``jit`` counterpart.
"""

__version__ = "0.1.0"
