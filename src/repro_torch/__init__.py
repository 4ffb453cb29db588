"""repro_torch — the PyTorch + CUDA port of the ROO recommendation framework.

It mirrors the JAX package ``repro`` path for path (``repro/core/hstu.py``
becomes ``repro_torch/core/hstu.py``) and never imports ``jax`` or
``repro``: the parity tests are the only code that sees both.

Ported so far (hstu-gr serving: stateless, user-tower cache, incremental;
hstu-gr training; roo-lsr serving and training in all four modes):
  scenario/knobs   the precedence ladder for runtime knobs
  core/            masks (incl. the cached-prefix spec), HSTU layer and its
                   prefix variant, ROO batch, sequence packing (incl. the
                   per-impression baseline), joiner, fanout, LCE/UserArch,
                   the impression-level expansion
  kernels/         hand-written CUDA kernels: HSTU forward, backward and
                   cached-prefix forward, embedding-bag forward and COO
                   backward; their plain torch versions and the
                   backend dispatch
  data/            jagged tensors, event simulation, ROO batcher
  embeddings/      local lookups (seq / row / jagged and padded bags, dedup
                   gather), bag pooling, COO row gradients (SparseRows)
  models/          MLP, GR ranking and its per-user state functions, LSR,
                   DCNv2
  configs/         hstu-gr and LSR configs
  serve/           bucketing, adapter, scoring engine (user-tower cache,
                   incremental state store), user_cache, ROOServer
  train/           optimizers, metrics, checkpoints, the train loop
  interop.py       carries parameter trees, user states and training
                   states from numpy

Entry points take an explicit ``device`` (default ``"cuda"``); the tests
pass ``device="cpu"``. The port is eager: there is no ``jit`` counterpart.
"""

__version__ = "0.1.0"
