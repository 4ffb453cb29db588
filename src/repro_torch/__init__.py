"""repro_torch — the PyTorch + CUDA port of the ROO recommendation framework.

It mirrors the JAX package ``repro`` path for path (``repro/core/hstu.py``
becomes ``repro_torch/core/hstu.py``) and never imports ``jax`` or
``repro``: the parity tests are the only code that sees both.

Ported so far: the eight recsys archs (hstu-gr, roo-lsr, roo-esr,
roo-retrieval, dlrm-mlperf, MIND, DIEN, BERT4Rec), trained dense or on
sparse rows and served stateless, through the user-tower cache or (hstu-gr)
incrementally, all built from one declarative spec:
  scenario/        the knob ladder; ``ScenarioSpec`` (the reference's
                   schema and hashes), ``build`` (models, Trainer, engine,
                   ``synthetic_dlrm_batches``), ``smoke``
  configs/         the roo_models configs and the arch / scenario registry
  launch/          ``python -m repro_torch.launch.train``
  obs/             metrics registry, spans, telemetry JSONL and its report,
                   the structured logger
  reliability/     seeded fault injection
  core/            masks (incl. the cached-prefix spec), HSTU layer and its
                   prefix variant, ROO batch, sequence packing (incl. the
                   per-impression baseline), joiner, fanout, LCE/UserArch,
                   the impression-level expansion
  kernels/         hand-written CUDA kernels: HSTU forward, backward and
                   cached-prefix forward, embedding-bag forward and COO
                   backward (grouped over a lookup's fields), the DLRM dot
                   interaction; their plain torch versions and the backend
                   dispatch
  data/            jagged tensors, event simulation, ROO batcher
  embeddings/      local lookups (seq / row / jagged and padded bags, dedup
                   gather, grouped bags), bag pooling, sparse rows
                   (``SparseRows``, ``GatheredTable``, the sparse
                   value_and_grad)
  models/          MLP, GR ranking and its per-user state functions, LSR,
                   DCNv2, DLRM and its dot interaction, two-tower, MIND,
                   DIN/DIEN, BERT4Rec
  serve/           bucketing, adapter, scoring engine (user-tower cache,
                   incremental state store), user_cache, ROOServer
  train/           optimizers, metrics, checkpoints, the train loop
  tree.py          nested containers of tensors (the reference's pytrees)
  interop.py       carries parameter trees, user states and training
                   states from numpy

Entry points take an explicit ``device`` (default ``"cuda"``); the tests
pass ``device="cpu"``. The port is eager: there is no ``jit`` counterpart.
"""

__version__ = "0.1.0"
