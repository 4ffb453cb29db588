"""The port's ``Trainer`` owns its state: a run never changes the tree that
``init_params_fn`` returned, so two ``run()``s from one shared tree start
from the same params and give the same losses, on the sparse-row path
(whose row-wise Adagrad writes the touched rows in place inside the
Trainer) and on the dense one. The reference's ``Trainer`` does the same
on the same inputs, and the port's losses follow its own.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embeddings import collection as jax_ec
from repro.embeddings import sparse as jax_sp
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings import sparse as sp
from repro_torch.interop import params_from_numpy
from repro_torch.train import loop, optim

LOSS_TOL = dict(atol=1e-7, rtol=1e-5)
N_STEPS = 6


def problem():
    """A mean bag over a 96-row table (sparse rows when declared), a
    20-row table under SPARSE_MIN_VOCAB, and a linear head."""
    rng = np.random.default_rng(21)
    params = {"emb": rng.normal(size=(96, 8)).astype(np.float32),
              "small_emb": rng.normal(size=(20, 8)).astype(np.float32),
              "w": rng.normal(size=(8,)).astype(np.float32)}
    batches = [{"ids": rng.integers(0, 96, size=(12, 4)).astype(np.int32),
                "lens": rng.integers(1, 5, size=(12,)).astype(np.int32),
                "small": rng.integers(0, 20, size=(12,)).astype(np.int32),
                "y": rng.normal(size=(12,)).astype(np.float32)}
               for _ in range(3)]
    return params, batches


def port_loss(p, b, gen):
    e = ec.bag_lookup_dense(p["emb"], b["ids"], b["lens"], "mean")
    e = e + ec.row_lookup(p["small_emb"], b["small"])
    return torch.mean((e @ p["w"] - b["y"]) ** 2)


def jax_loss(p, b, r):
    e = jax_ec.bag_lookup_dense(p["emb"], b["ids"], b["lens"], "mean")
    e = e + jax_ec.row_lookup(p["small_emb"], b["small"])
    return jnp.mean((e @ p["w"] - b["y"]) ** 2)


def table_ids(b):
    return {"emb": b["ids"], "small_emb": b["small"]}


def mixed(lib):
    return lib.make_mixed(lib.adam(1e-2), lib.rowwise_adagrad(0.1),
                          lib.default_is_embedding)


def cycling(batches):
    return lambda start: (batches[i % len(batches)]
                          for i in itertools.count(start))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_two_runs_from_one_tree(sparse):
    params, batches = problem()
    shared = params_from_numpy(params, "cpu")
    before = tree.tree_map(torch.clone, shared)
    pb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    vag = (sp.make_sparse_value_and_grad(port_loss, table_ids) if sparse
           else None)
    trainer = loop.Trainer(port_loss, mixed(optim),
                           loop.TrainLoopConfig(total_steps=N_STEPS,
                                                log_every=1),
                           lambda: shared, value_and_grad_fn=vag,
                           device="cpu")
    states = [trainer.run(cycling(pb), 0) for _ in range(2)]
    runs = [[r["loss"] for r in trainer.history[i * N_STEPS:
                                                (i + 1) * N_STEPS]]
            for i in range(2)]
    assert runs[0] == runs[1]
    for a, b in zip(tree.leaves(states[0]["params"]),
                    tree.leaves(states[1]["params"])):
        assert torch.equal(a, b)
    for k in params:
        assert torch.equal(shared[k], before[k]), k
        assert not torch.equal(states[0]["params"][k], shared[k]), k
        assert all(s["params"][k] is not shared[k] for s in states)

    jp = jax.tree.map(jnp.asarray, params)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    jvag = (jax_sp.make_sparse_value_and_grad(jax_loss, table_ids) if sparse
            else None)
    jt = jax_loop.Trainer(jax_loss, mixed(jax_optim),
                          jax_loop.TrainLoopConfig(total_steps=N_STEPS,
                                                   log_every=1),
                          lambda: jp, value_and_grad_fn=jvag)
    for _ in range(2):
        jt.run(cycling(jb), jax.random.PRNGKey(0))
    jruns = [[r["loss"] for r in jt.history[i * N_STEPS:(i + 1) * N_STEPS]]
             for i in range(2)]
    assert jruns[0] == jruns[1]
    for k in params:
        np.testing.assert_array_equal(np.asarray(jp[k]), params[k])
    np.testing.assert_allclose(runs[0], jruns[0], **LOSS_TOL)
