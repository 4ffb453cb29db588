#!/usr/bin/env python3
"""Where a launch of the HSTU forward kernels (B1, B4) spends its time.

Run from the repo root on a machine with one NVIDIA H100:

    python3 scripts/hstu_fwd_ablations.py

Builds the two kernels (``src/repro_torch/kernels/csrc/``) once as they
are and once for each ablation of the shared tile body
(``hstu_fwd_tile.cuh``), each variant with its own copy of the header under
``build/ablations/``, and prints each variant's device time per call
(``chip_smoke.device_ms``) at B1's serving and training shapes, at the
gr-train-long cell's (B 2, H 8, S 8,256, D 128, ``max_rel_pos`` 8,256;
``chip_smoke.GR_LONG_REQUESTS`` and the traffic's short end,
``GR_LONG_SHORT``) and B4's serving shape with n_new 8 and 64, beside an
empty launch. The ablations give wrong outputs on purpose; only "as built"
is the kernel. They are:

  no mma         the tensor-core products replaced by a few adds
  1xTF32         hi*hi only (one mma a product instead of three)
  no SiLU        SiLU(x) = x
  no tiles       no tile is multiplied: launch, lengths, copies, barriers,
                 the split's sum and the stores only
  parent's skip  B1's tile skip without the rows' validity (a padded
                 history row walks the valid history's tiles, as before
                 the skip read it; same output)
  whole rab row  every block stages the head's whole rab row (2 max_rel + 1
                 bins, not max_rel + 1: one block an SM at gr-train-long's
                 shape; same output)

Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablations"
SOURCES = ("hstu_attention_fwd.cu", "hstu_attention_prefix_fwd.cu")
MMA = '  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "'


LIVE = ("  __device__ bool live(int i_lo, int i_hi, int j_lo, int j_hi) "
        "const {\n    const int hrow_hi")


def variants(header: str) -> dict:
    edits = {
        "no mma": [(MMA, "  c[0] += __uint_as_float(a[0] ^ b[0]);\n"
                         "  c[2] += __uint_as_float(a[2] ^ b[1]);\n"
                         "  if (0)" + MMA[1:])],
        "1xTF32": [("  mma_tf32(c, a.lo, bh);\n  mma_tf32(c, a.hi, bl);\n",
                    "")],
        "no SiLU": [("return x / (1.0f + expf(-x));", "return x;")],
        "no tiles": [("if (tile_live(kt, wq0, wq_last)) {", "if (kt < 0) {")],
        "parent's skip": [(LIVE, LIVE.replace(
            "\n", "\n    return (j_lo < hist_end && i_hi >= j_lo) ||\n"
            "           max(max(j_lo, n_hist), i_lo) <=\n"
            "               min(min(j_hi, tgt_end - 1), i_hi);\n", 1))],
        "whole rab row": [
            ("return use_rab ? max_rel + 1 : 0;",
             "return use_rab ? 2 * max_rel + 1 : 0;"),
            ("load_rab(rab_s, a.rab + a.max_rel, a.max_rel + 1);",
             "load_rab(rab_s, a.rab, 2 * a.max_rel + 1);"),
            ("x += rab_s[min(L.pos(r) - c, a.max_rel)];",
             "x += rab_s[min(max(L.pos(r) - c, -a.max_rel), a.max_rel) +\n"
             "                          a.max_rel];")],
    }
    out = {"as built": header}
    for name, pairs in edits.items():
        text = header
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"ablation {name!r}: its edit no longer "
                                 f"applies")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(name: str, header: str, nvcc: str, flags) -> list:
    d = OUT / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "hstu_fwd_tile.cuh").write_text(header)
    libs = []
    for src in SOURCES:
        shutil.copy(CSRC / src, d / src)
        lib = d / f"{Path(src).stem}.so"
        proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(d / src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
        libs.append(lib)
    return libs


def bind(libs):
    vp, i = ctypes.c_void_p, ctypes.c_int
    b1, b4 = (ctypes.CDLL(str(p)) for p in libs)
    b1.hstu_attention_fwd.argtypes = [vp] * 7 + [i] * 8 + [vp]
    b1.hstu_attention_fwd_smem_bytes.argtypes = [i] * 4
    b1.hstu_attention_fwd_smem_bytes.restype = ctypes.c_longlong
    b1.hstu_attention_fwd_error_string.argtypes = [i]
    b1.hstu_attention_fwd_error_string.restype = ctypes.c_char_p
    b4.hstu_attention_prefix_fwd.argtypes = [vp] * 8 + [i] * 11 + [vp]
    b4.hstu_attention_prefix_fwd_smem_bytes.argtypes = [i] * 4
    b4.hstu_attention_prefix_fwd_smem_bytes.restype = ctypes.c_longlong
    b4.hstu_attention_prefix_fwd_error_string.argtypes = [i]
    b4.hstu_attention_prefix_fwd_error_string.restype = ctypes.c_char_p
    return b1, b4


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hstu_fwd_ablations: needs the card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import hstu_attention as kmod
    from repro_torch.kernels import hstu_attention_prefix as pmod
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    found = variants((CSRC / "hstu_fwd_tile.cuh").read_text())
    nvcc = kmod._nvcc()
    with ThreadPoolExecutor(len(found)) as pool:
        libs = dict(zip(found, pool.map(
            lambda kv: build(*kv, nvcc, kmod.NVCC_FLAGS), found.items())))

    def b1_args(b):
        x = cs.attention_inputs((b, 2, 80, 32, 32, 64, 64), seed=0,
                                device=dev)
        return (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["hl"],
                x["tc"], x["max_rel"])

    def b4_args(n_new):
        x = cs.prefix_inputs((64, 2, 64, n_new, 16, 32, 32, 64, 80),
                             seed=11, device=dev)
        return (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["n_new"],
                x["pfx"], x["nc"], x["tc"], x["scale_len"], x["max_rel"])

    def gr_long_args(requests):
        x = cs.gr_long_inputs(dev)
        hl, tc = (torch.tensor(t, device=dev) for t in zip(*requests))
        return (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], hl, tc,
                x["max_rel"])

    # {case: (function, arguments, calls timed)}
    cases = {"B1 serve B64": (kmod.hstu_attention_cuda, b1_args(64), 200),
             "B1 train B32": (kmod.hstu_attention_cuda, b1_args(32), 200),
             "B1 gr-long": (kmod.hstu_attention_cuda,
                            gr_long_args(cs.GR_LONG_REQUESTS), 5),
             "B1 gr-long short": (kmod.hstu_attention_cuda,
                                  gr_long_args(cs.GR_LONG_SHORT), 5),
             "B4 n_new 8": (pmod.hstu_attention_prefix_cuda, b4_args(8), 200),
             "B4 n_new 64": (pmod.hstu_attention_prefix_cuda, b4_args(64),
                             200)}
    print(f"[ablations] {cs.card_line()}: device ms per call "
          f"(chip_smoke.device_ms, 200 calls); empty launch "
          f"{cs.device_ms(lambda: torch.cuda._sleep(0), 200):.5f} ms")
    for rnd in (1, 2):
        for name, pair in libs.items():
            kmod._lib, pmod._lib = bind(pair)
            times = {case: cs.device_ms(lambda: fn(*args), n)
                     for case, (fn, args, n) in cases.items()}
            print(f"[ablations] round {rnd} {name:13s} " + ", ".join(
                f"{case} {ms:.5f}" for case, ms in times.items()),
                flush=True)
    kmod._lib = pmod._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
