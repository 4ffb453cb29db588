"""``python -m repro_torch.launch.dryrun`` against the reference's own dry
run on the same seven cells (``torch_spmd_ranks.DRYRUN_CELLS``), both on
a 2 x 4 (data x model) mesh: the reference lowered, compiled and analyzed
by ``hlo_analysis`` on 8 forced host devices with Auto axes
(``torch_ref_cells.py dryrun``), the port traced on meta tensors over a
fake world of 8 ranks (``launch/op_analysis.py``).

Per-device FLOPs: where both sides run the same products they agree
exactly; each cell where they differ differs by one named term, and the
test holds the port's count to the reference's plus that term (0.5 %):

  * mind serve_p99: + the capsule routing's last logit update, which no
    output reads (XLA removes it; eager torch runs it);
  * dlrm-mlperf: - (n_model - 1) / n_model of the dot interaction: the
    port's plan route runs it on this rank's D / n_model slice and sums
    the pairs over ``model`` (``models/dlrm.py``), GSPMD runs it whole on
    every model rank;
  * starcoder2-15b decode_32k: + (n_model - 1) / n_model of the
    attention projections: the port's decode runs q / k / v / o whole on
    every model rank (``models/lm/decode.py``);
  * granite-moe-3b-a800m train_4k: + (n_model - 1) / n_model of the K/V
    projection in each of its four passes (forward, recompute, two
    backward products): the port's Megatron-SP layer computes every KV
    head on every model rank.

MACE differs from the reference by more than one term: XLA removes the
products no output reads (the last layer's l > 0 features), folds the
first layer's products of its all-zero l > 0 features and contracts the
three-operand CG products in another order than torch's einsum. So the
test holds the port's MACE count to its analytic
form (:func:`_mace_step_flops`: each product of the step, counted as
``FlopCounterMode`` counts it, over this rank's nodes and edges), checks
that the plan route splits the one-device count 8 ways, and bounds the gap
to the reference.

The CLI's ``--opt-level`` reaches the LM's opt levels: granite train_4k
``flash`` (q-chunked attention) runs the same products with a lower peak.

Argument bytes (the rank's state and inputs) agree within 1 %.
"""
import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_spmd_ranks as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("arch", "shape", "kind", "mesh", "n_chips", "opt_level", "ok",
        "trace_s", "memory_analysis", "cost_analysis", "collectives",
        "collective_bytes", "collective_bytes_by_axis", "roofline",
        "model_flops", "useful_flops_ratio", "notes", "analysis")
N_MODEL, N_DATA = 4, 2


def _cells_arg(cells):
    return ",".join(f"{a}/{s}/{lv}" for a, s, lv in cells)


def _port_json(out, mesh, arch, shape, level):
    tag = f"{arch}__{shape}__pod1__{mesh}"
    if level != "baseline":
        tag += f"__{level}"
    return json.loads((out / f"{tag}.json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ref_cells.py"),
         "dryrun", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
           str(out)]
    one = subprocess.Popen(dry + ["--mesh", "1x1", "--cells",
                                  "mace/molecule"], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    flash = subprocess.Popen(dry + ["--mesh", "2x4", "--arch",
                                    "granite-moe-3b-a800m", "--shape",
                                    "train_4k", "--opt-level", "flash"],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    port = subprocess.run(dry + ["--mesh", "2x4", "--cells",
                                 _cells_arg(R.DRYRUN_CELLS)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    o_out, o_err = one.communicate(timeout=600)
    f_out, f_err = flash.communicate(timeout=600)
    r_out, r_err = ref.communicate(timeout=600)
    assert port.returncode == 0, port.stdout[-2000:] + port.stderr[-3000:]
    assert one.returncode == 0, o_err[-3000:]
    assert flash.returncode == 0 and f_out.startswith("OK "), f_err[-3000:]
    assert "REF_DRYRUN_DONE" in r_out, r_err[-3000:]
    ref_res = json.loads((out / "ref_dryrun.json").read_text())
    got = {f"{a}/{s}/{lv}": _port_json(out, "2x4", a, s, lv)
           for a, s, lv in R.DRYRUN_CELLS}
    return {"out": out, "port": got, "ref": ref_res, "stdout": port.stdout,
            "mace_1x1": _port_json(out, "1x1", "mace", "molecule",
                                   "baseline"),
            "granite_flash": _port_json(out, "2x4", "granite-moe-3b-a800m",
                                        "train_4k", "flash")}


def _flops(r, tag):
    return r["port"][tag]["cost_analysis"]["flops"], r["ref"][tag]["flops"]


def test_every_cell_prints_ok(runs):
    ok = [ln for ln in runs["stdout"].splitlines() if ln.startswith("OK ")]
    assert len(ok) == len(R.DRYRUN_CELLS)


@pytest.mark.parametrize("tag", [f"{a}/{s}/{lv}"
                                 for a, s, lv in R.DRYRUN_CELLS])
def test_json_carries_the_keys(runs, tag):
    r = runs["port"][tag]
    assert set(KEYS) <= set(r)
    assert r["n_chips"] == 8 and r["mesh"] == "2x4" and r["ok"]
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                  "dominant"}
    assert r["useful_flops_ratio"] == pytest.approx(
        r["model_flops"] / 8 / r["cost_analysis"]["flops"])
    assert r["model_flops"] == runs["ref"][tag]["model_flops"]
    # nothing but meta tensors was made
    assert r["analysis"]["tensor_devices"] == ["meta"]


@pytest.mark.parametrize("tag", [f"{a}/{s}/{lv}"
                                 for a, s, lv in R.DRYRUN_CELLS])
def test_argument_bytes_agree(runs, tag):
    got = runs["port"][tag]["memory_analysis"]["argument_bytes"]
    want = runs["ref"][tag]["argument_bytes"]
    assert got == pytest.approx(want, rel=0.01)


def _mind_last_update():
    from repro_torch.configs.recsys_cells import RECSYS_SHAPES
    b_ro = RECSYS_SHAPES["serve_p99"]["b_ro"] // N_DATA
    t, k, d = 64, 4, 64
    return b_ro * 2 * t * k * d


def _dlrm_interaction(shape, passes):
    from repro_torch.configs.recsys_cells import RECSYS_SHAPES
    from repro_torch.models.dlrm import DLRMConfig
    cfg = DLRMConfig()
    f = cfg.n_sparse + 1
    b = RECSYS_SHAPES[shape]["b_nro"] // N_DATA
    return -(1 - 1 / N_MODEL) * passes * 2 * f * f * cfg.embed_dim * b


def _starcoder_attention():
    from repro_torch.configs.registry import get_arch
    c = get_arch("starcoder2-15b").CONFIG
    d, h, kv, dh = c.d_model, c.n_heads, c.n_kv_heads, c.d_head
    attn = d * h * dh + d * 2 * kv * dh + h * dh * d
    b = 128 // N_DATA
    return (1 - 1 / N_MODEL) * 2 * b * c.n_layers * attn


def _granite_kv():
    from repro_torch.configs.registry import get_arch
    c = get_arch("granite-moe-3b-a800m").CONFIG
    tokens = 256 * 4096 // N_DATA
    kv_proj = 2 * c.d_model * 2 * c.n_kv_heads * c.d_head
    return (1 - 1 / N_MODEL) * 4 * tokens * c.n_layers * kv_proj


TERMS = {"mind/serve_p99/baseline": _mind_last_update,
         "dlrm-mlperf/serve_p99/baseline":
             lambda: _dlrm_interaction("serve_p99", 1),
         "dlrm-mlperf/train_batch/baseline":
             lambda: _dlrm_interaction("train_batch", 3),
         "dlrm-mlperf/train_batch/impression":
             lambda: _dlrm_interaction("train_batch", 3),
         "starcoder2-15b/decode_32k/baseline": _starcoder_attention,
         "granite-moe-3b-a800m/train_4k/baseline": _granite_kv}


@pytest.mark.parametrize("tag", sorted(TERMS))
def test_flops_are_the_references_plus_the_named_term(runs, tag):
    got, want = _flops(runs, tag)
    assert got == pytest.approx(want + TERMS[tag](), rel=0.005)


def _counted(fn, *shapes, grads):
    """What ``FlopCounterMode`` counts for ``fn`` on meta tensors of
    ``shapes`` and its backward (for the ones flagged in ``grads``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    xs = [torch.empty(s, device="meta", requires_grad=g)
          for s, g in zip(shapes, grads)]
    fc = FlopCounterMode(display=False)
    with fc:
        out = fn(*xs)
        if any(grads):
            out.backward(torch.empty_like(out))
    return fc.get_total_flops()


def _mm(rows, k, m, gin):
    """A (rows, k) @ (k, m) product with a weight gradient, and an input
    gradient when ``gin``."""
    return 2 * rows * k * m * (2 + gin)


def _mace_step_flops(cfg, n, e):
    """The MACE cell's step on ``n`` nodes and ``e`` edges: forward and
    backward of every product, except the last layer's dead ones (the
    top correlation order's l3 > 0 products, the l > 0 update and
    residual: forward only), and no input gradient for layer 0's
    all-zero l > 0 features."""
    import torch

    from repro_torch.models.gnn.irreps import DIMS as d
    from repro_torch.models.gnn.irreps import cg_paths
    c, ls, paths = cfg.channels, range(cfg.l_max + 1), cg_paths(cfg.l_max)

    def message(l1, l2, l3):               # CG(Y, h_j): h_j's gradient
        return _counted(
            lambda cg, y, h: torch.einsum("abk,ea,ebc->ekc", cg, y, h),
            (d[l1], d[l2], d[l3]), (e, d[l1]), (e, d[l2], c),
            grads=(False, False, True))

    def product(l1, l2, l3, live):         # CG(B_{v-1}, A)
        return _counted(
            lambda cg, a, b: torch.einsum("abk,nac,nbc->nkc", cg, a, b),
            (d[l1], d[l2], d[l3]), (n, d[l1], c), (n, d[l2], c),
            grads=(False, live, live))

    f = _mm(n, cfg.n_feat_in, c, gin=False)                    # embed
    for t in range(cfg.n_layers):
        last = t == cfg.n_layers - 1
        f += _mm(e, cfg.n_rbf, 64, gin=False)                  # radial
        f += _mm(e, 64, len(paths) * c, gin=True)
        f += sum(_mm(n * d[l], c, c, gin=t > 0 or l == 0) for l in ls)
        f += sum(message(*p) for p in paths)
        for v in range(2, cfg.correlation + 1):
            for p in paths:
                live = not (last and v == cfg.correlation and p[2] > 0)
                f += product(*p, live)
                f += _mm(n * d[p[2]], c, c, gin=True) if live \
                    else 2 * n * d[p[2]] * c * c
        for l in ls:                                   # update, residual
            if last and l > 0:
                f += 2 * n * d[l] * c * c * (cfg.correlation + 1)
            else:
                f += _mm(n * d[l], cfg.correlation * c, c, gin=True)
                f += _mm(n * d[l], c, c, gin=t > 0 or l == 0)
        dims = (c,) + cfg.readout_mlp + (cfg.n_out,)
        f += sum(_mm(n, a, b, gin=True) for a, b in zip(dims, dims[1:]))
    return f


def test_mace_flops_split_over_the_mesh(runs):
    from repro_torch.configs.mace_cells import MACE_SHAPES
    from repro_torch.models.gnn.mace import MACEConfig
    got, want = _flops(runs, "mace/molecule/baseline")
    sh = MACE_SHAPES["molecule"]
    cfg = MACEConfig(n_feat_in=sh["d_feat"], n_out=sh["n_out"])
    n, e = sh["n_nodes"] // 8, sh["n_edges"] // 8
    assert got == pytest.approx(_mace_step_flops(cfg, n, e), rel=1e-9)
    one = runs["mace_1x1"]["cost_analysis"]["flops"]
    assert got * 8 == pytest.approx(one, rel=1e-9)
    # a collective over a group of one moves nothing
    assert runs["mace_1x1"]["collective_bytes"] == 0
    # the products XLA removes or folds, eager torch runs
    assert want < got < 1.2 * want


def test_cli_opt_level_reaches_the_lm_levels(runs):
    flash = runs["granite_flash"]
    base = runs["port"]["granite-moe-3b-a800m/train_4k/baseline"]
    assert flash["opt_level"] == "flash"
    # q-chunked attention: the same products, no (S, S) scores held
    assert flash["cost_analysis"]["flops"] == base["cost_analysis"]["flops"]
    assert flash["memory_analysis"]["peak_bytes"] < \
        0.9 * base["memory_analysis"]["peak_bytes"]
    assert flash["memory_analysis"]["argument_bytes"] == \
        base["memory_analysis"]["argument_bytes"]


def test_train_cells_communicate(runs):
    for tag in ("dlrm-mlperf/train_batch/baseline",
                "granite-moe-3b-a800m/train_4k/baseline"):
        assert runs["port"][tag]["collective_bytes"] > 0
        assert runs["ref"][tag]["collective_bytes"] > 0


def test_impression_costs_more_than_roo(runs):
    imp, _ = _flops(runs, "dlrm-mlperf/train_batch/impression")
    roo, _ = _flops(runs, "dlrm-mlperf/train_batch/baseline")
    assert imp > roo


def test_moe_train_flops_scale(runs):
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("granite-moe-3b-a800m").CONFIG
    got, _ = _flops(runs, "granite-moe-3b-a800m/train_4k/baseline")
    assert got > 2.0 * cfg.n_active_params() * 256 * 4096 / 8
