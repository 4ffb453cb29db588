"""The port's op-level step analyzer (``launch/op_analysis.py``), on the
pattern of ``tests/test_hlo_analysis.py``: FLOPs of known products, loops,
gradients and a checkpointed layer's recompute, the collectives of a fake
world of 8 with their bytes and axes, and the peak of a known sequence of
allocations. Everything runs on meta tensors."""
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.op_analysis import analyze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


class TestFlops:
    def test_plain_product_counts_2mnk(self):
        a = analyze(lambda x, y: x @ y, meta(128, 256), meta(256, 512))
        assert a["flops"] == 2 * 128 * 256 * 512

    @pytest.mark.parametrize("n_layers", [2, 8, 32])
    def test_loop_counts_every_layer(self, n_layers):
        def f(x, w):
            for i in range(n_layers):
                x = x @ w[i]
            return x.sum()
        a = analyze(f, meta(128, 256), meta(n_layers, 256, 256))
        assert a["flops"] == n_layers * 2 * 128 * 256 * 256

    def test_gradient_counts_forward_and_backward(self):
        def f(w, x):
            loss = torch.tanh(x @ w).sum()
            return torch.autograd.grad(loss, w)[0]
        a = analyze(f, meta(256, 256, grad=True), meta(128, 256))
        fwd = 2 * 128 * 256 * 256
        # dW = xᵀ g; no dx (x needs no gradient)
        assert a["flops"] == 2 * fwd

    def test_checkpointed_layer_counts_its_recompute(self):
        def f(w, x):
            y = checkpoint(lambda t: torch.tanh(t @ w), x, use_reentrant=False)
            return torch.autograd.grad(y.sum(), w)[0]
        a = analyze(f, meta(256, 256, grad=True), meta(64, 256))
        assert a["flops"] == 3 * 2 * 64 * 256 * 256

    def test_einsum_and_bmm(self):
        a = analyze(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                    meta(4, 8, 16), meta(4, 16, 32))
        assert a["flops"] == 2 * 4 * 8 * 16 * 32


class TestBytes:
    def test_unfused_bytes_are_inputs_plus_outputs(self):
        a = analyze(lambda x: (x * 2) + 1, meta(1000))
        # mul reads 4000 and writes 4000; add reads 4000 and writes 4000
        assert a["memory_bytes"] == 16000

    def test_views_move_nothing(self):
        a = analyze(lambda x: x.reshape(10, 100).t()[:5], meta(1000))
        assert a["memory_bytes"] == 0

    def test_gather_counts_rows_touched(self):
        table, ids = meta(1_000_000, 64), torch.empty(
            (32,), dtype=torch.int64, device="meta")
        a = analyze(lambda t, i: t[i], table, ids)
        assert a["memory_bytes"] == 2 * 32 * 64 * 4 + 32 * 8

    def test_argument_and_output_bytes(self):
        a = analyze(lambda x, y: x @ y, meta(8, 16), meta(16, 4))
        assert a["argument_bytes"] == (8 * 16 + 16 * 4) * 4
        assert a["output_bytes"] == 8 * 4 * 4

    def test_peak_of_a_known_sequence(self):
        def f(x):
            t1 = torch.zeros(1000, device="meta")        # 4000 live
            t2 = torch.zeros(2000, device="meta")        # 12000 live
            del t1                                        # 8000 live
            t3 = torch.zeros(500, device="meta")         # 10000 live
            v = t3.view(5, 100)                          # a view: no bytes
            return t2, v
        a = analyze(f, meta(250))                        # 1000 B argument
        assert a["argument_bytes"] == 1000
        assert a["peak_bytes"] == 1000 + 12000
        assert a["output_bytes"] == 8000 + 2000

    def test_saved_for_backward_stays_live(self):
        def f(w):
            h = torch.tanh(w * 2)                        # saved by tanh
            return torch.autograd.grad(h.sum(), w)[0]
        a = analyze(f, meta(1000, grad=True))
        # w (4000) + w*2 (4000) + tanh (4000, saved) at least together
        assert a["peak_bytes"] >= 12000


_FAKE_WORLD = r'''
import json, warnings
import torch
warnings.filterwarnings("ignore")
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import plan_for_mesh
from repro_torch.launch.dryrun import _world_and_mesh
from repro_torch.launch.op_analysis import analyze

mesh = _world_and_mesh("2x4")
plan = plan_for_mesh(mesh)

def step(x):
    m = spmd.plan_axes(plan, "model")
    d = spmd.plan_axes(plan, "data")
    y = coll.all_gather_dim(x, m, 0)                     # (32, 16) out
    z = coll.reduce_scatter_dim(y, d, 0)                 # (16, 16) out
    w = coll.all_reduce_sum(z, [mesh.group("data")])     # (16, 16)
    v = coll.all_to_all(w, mesh.group("model"), 4, 0, 1)  # (4, 64)
    return v

a = analyze(step, torch.empty((8, 16), device="meta"), mesh=mesh)
del a["outputs"]
print("RESULT=" + json.dumps(a))
'''


def test_collectives_of_a_fake_world_of_8():
    import json
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _FAKE_WORLD], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    a = json.loads([ln for ln in r.stdout.splitlines()
                    if ln.startswith("RESULT=")][0][len("RESULT="):])
    f32 = 4
    assert a["collectives"] == {
        "all-gather": {"count": 1, "bytes": 32 * 16 * f32},
        "reduce-scatter": {"count": 1, "bytes": 16 * 16 * f32},
        "all-reduce": {"count": 1, "bytes": 16 * 16 * f32},
        "all-to-all": {"count": 1, "bytes": 16 * 16 * f32}}
    assert a["collective_bytes_by_axis"] == {
        "model": (32 * 16 + 16 * 16) * f32,
        "data": (16 * 16 + 16 * 16) * f32}
    assert a["collective_bytes"] == sum(
        v["bytes"] for v in a["collectives"].values())
    assert a["flops"] == 0
