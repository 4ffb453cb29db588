"""The port's BERT4Rec held against the JAX reference, on
``tests/test_torch_recsys_archs.py``'s helpers and sizes (seq_len 65):
init tree and config, scores to 1e-5, the loss to rtol 1e-5 and its
gradients per leaf to 1e-4 with the reference's cloze draws handed over,
the cloze loss through its mask seam, a 20-step dense Trainer against the
reference's and the ``ROOServer``. BERT4Rec has no sparse path: its cloze
head is a full softmax over ``item_emb``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import bert4rec as jax_b4r
from repro_torch.models import bert4rec as b4r

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_recsys_archs import (LOSS_TOL, arch, check_init,  # noqa: E402
                                     check_loss_grads, check_scores,
                                     check_server, check_trainer,
                                     cloze_draws, make_data, make_params)

CHECKS = {"init": lambda d, p: check_init("bert4rec"),
          "scores": lambda d, p: check_scores(d, p, "bert4rec"),
          "loss_grads": lambda d, p: check_loss_grads(d, p, "bert4rec"),
          "trainer_20_steps": lambda d, p: check_trainer(d, p, "bert4rec"),
          "server": lambda d, p: check_server(d, p, "bert4rec")}


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def params():
    return make_params(["bert4rec"])


@pytest.mark.parametrize("check", list(CHECKS))
def test_matches_reference(data, params, check):
    CHECKS[check](data, params)


def test_bert4rec_cloze_mask_seam(data, params):
    """The cloze loss from the reference's draws equals the reference's;
    from a generator's draws it is finite and the same on repeat."""
    a = arch("bert4rec")
    pp, jp = params["bert4rec"]
    pb, jb = data["pb"][2], data["jb"][2]
    ids, lens = pb.history_ids[:, :65], torch.clamp(pb.history_lengths,
                                                    max=65)
    key = jax.random.PRNGKey(5)
    u = cloze_draws(key, pb, a.cfg)
    want = jax_b4r.cloze_loss(jp, a.jcfg, jb.history_ids[:, :65],
                              jnp.minimum(jb.history_lengths, 65), key)
    got = b4r.cloze_loss(pp, a.cfg, ids, lens, uniform=torch.from_numpy(u))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    drawn = b4r.cloze_loss(pp, a.cfg, ids, lens,
                           torch.Generator().manual_seed(0))
    again = b4r.cloze_loss(pp, a.cfg, ids, lens,
                           torch.Generator().manual_seed(0))
    assert np.isfinite(float(drawn)) and float(drawn) == float(again)
