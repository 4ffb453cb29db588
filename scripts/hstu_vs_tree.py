#!/usr/bin/env python3
"""The fp32 HSTU kernels (B1, B4, B2 + B3) of this tree against those of
another checkout, bit for bit: a change that adds a variant or edits the
shared tile header must leave the fp32 kernels' outputs as they were.

Run from the repo root on a machine with one NVIDIA H100:

    python3 scripts/hstu_vs_tree.py OTHER

where OTHER is the root of the other checkout (e.g. the parent commit
unpacked with ``git archive``). Builds OTHER's three HSTU sources with this
tree's nvcc flags under ``build/other_kernels/``, calls their fp32 C entry
points through ctypes beside this tree's wrappers on the same inputs
(``chip_smoke.attention_inputs`` / ``prefix_inputs``: B1 and B2 + B3 at
``chip_smoke.B1_SHAPES`` and a D 18 / 13 shape, B4 at the serving shape
with n_new 1, 8 and 64; rab on and off), and fails on the first output
that differs. The other tree's C interface must be this one's fp32 one.

Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "other_kernels"
SOURCES = ("hstu_attention_fwd.cu", "hstu_attention_prefix_fwd.cu",
           "hstu_attention_bwd.cu")


def build(csrc: Path, src: str, nvcc: str, flags) -> ctypes.CDLL:
    lib = OUT / (Path(src).stem + ".so")
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(csrc / src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{src}: nvcc failed\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available() or len(argv) != 1:
        print("hstu_vs_tree: needs the card and the other checkout's root",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import hstu_attention as kmod
    from repro_torch.kernels import hstu_attention_bwd as bmod
    from repro_torch.kernels import hstu_attention_prefix as pmod
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    csrc = Path(argv[0]).resolve() / "src" / "repro_torch" / "kernels" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        f1, f4, fb = pool.map(lambda s: build(csrc, s, kmod._nvcc(),
                                              kmod.NVCC_FLAGS), SOURCES)
    vp, i = ctypes.c_void_p, ctypes.c_int
    f1.hstu_attention_fwd.argtypes = [vp] * 7 + [i] * 8 + [vp]
    f4.hstu_attention_prefix_fwd.argtypes = [vp] * 8 + [i] * 11 + [vp]
    fb.hstu_attention_bwd_dq.argtypes = [vp] * 9 + [i] * 8 + [vp]
    fb.hstu_attention_bwd_dkv.argtypes = [vp] * 9 + [i] * 8 + [vp]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()

    def check(err: int, what: str) -> None:
        if err:
            raise SystemExit(f"the other tree's {what} failed ({err})")

    def other_b1(x, rab):
        b, h, s, d = x["q"].shape
        dv = x["v"].shape[-1]
        out = torch.empty(b, h, s, dv, device=dev)
        check(f1.hstu_attention_fwd(
            ptr(x["q"]), ptr(x["k"]), ptr(x["v"]), ptr(rab), ptr(x["hl"]),
            ptr(x["tc"]), ptr(out), b, h, s, d, dv, x["n_hist"],
            x["max_rel"], int(rab is not None), stream()), "B1")
        return out

    def other_b4(x, rab):
        b, h, r, d = x["q"].shape
        c, dv = x["k"].shape[2], x["v"].shape[-1]
        out = torch.empty(b, h, r, dv, device=dev)
        check(f4.hstu_attention_prefix_fwd(
            ptr(x["q"]), ptr(x["k"]), ptr(x["v"]), ptr(rab), ptr(x["pfx"]),
            ptr(x["nc"]), ptr(x["tc"]), ptr(out), b, h, r, c, d, dv,
            x["n_hist"], x["n_new"], x["scale_len"], x["max_rel"],
            int(rab is not None), stream()), "B4")
        return out

    def other_bwd(x, rab, g):
        b, h, s, d = x["q"].shape
        dv = x["v"].shape[-1]
        n_blocks = -(-s // bmod.rows_per_block(b * h, s))
        dq, dk, dvv = (torch.empty_like(x["q"]), torch.empty_like(x["k"]),
                       torch.empty_like(x["v"]))
        part = torch.empty((h, 2 * x["max_rel"] + 1, b * n_blocks)
                           if rab is not None else (0,), device=dev)
        head = (ptr(x["q"]), ptr(x["k"]), ptr(x["v"]), ptr(rab), ptr(g),
                ptr(x["hl"]), ptr(x["tc"]))
        tail = (b, h, s, d, dv, x["n_hist"], x["max_rel"],
                int(rab is not None), stream())
        check(fb.hstu_attention_bwd_dq(
            *head, ptr(dq), ptr(part) if rab is not None else None, *tail),
            "B2")
        check(fb.hstu_attention_bwd_dkv(*head, ptr(dk), ptr(dvv), *tail),
              "B3")
        return dq, dk, dvv, (part.sum(-1) if rab is not None else None)

    def same(a, b) -> bool:
        return all((u is None and v is None) or torch.equal(u, v)
                   for u, v in zip(a, b))

    n_bad = 0
    shapes = dict(cs.B1_SHAPES, **{"short S17 D18/13": (7, 3, 17, 18, 13, 12,
                                                        8)})
    for name, shape in shapes.items():
        x = cs.attention_inputs(shape, seed=3, device=dev)
        g = torch.randn_like(x["v"])
        for rab in (x["rab"], None):
            args = (x["q"], x["k"], x["v"], rab, x["n_hist"], x["hl"],
                    x["tc"], x["max_rel"])
            b1 = torch.equal(kmod.hstu_attention_cuda(*args),
                             other_b1(x, rab))
            bwd = same(bmod.hstu_attention_bwd_cuda(*args, g),
                       other_bwd(x, rab, g))
            n_bad += (not b1) + (not bwd)
            print(f"[vs tree] {name} rab={rab is not None}: B1 bitwise={b1} "
                  f"B2/B3 bitwise={bwd}", flush=True)
    for n_new in (1, 8, 64):
        x = cs.prefix_inputs((64, 2, 64, n_new, 16, 32, 32, 64, 80), seed=4,
                             device=dev)
        for rab in (x["rab"], None):
            b4 = torch.equal(pmod.hstu_attention_prefix_cuda(
                x["q"], x["k"], x["v"], rab, x["n_hist"], x["n_new"],
                x["pfx"], x["nc"], x["tc"], x["scale_len"], x["max_rel"]),
                other_b4(x, rab))
            n_bad += not b4
            print(f"[vs tree] B4 n_new={n_new} rab={rab is not None}: "
                  f"bitwise={b4}", flush=True)
    torch.cuda.synchronize()
    if n_bad:
        print(f"hstu_vs_tree: {n_bad} outputs differ", file=sys.stderr)
        return 1
    print("[vs tree] every fp32 output equals the other tree's, bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
