#!/usr/bin/env python3
"""Where a launch of the HSTU backward kernels (B2: dq + drab, B3: dk + dv)
spends its time.

Run from the repo root on a machine with one NVIDIA H100:

    python3 scripts/hstu_bwd_ablations.py

Builds ``src/repro_torch/kernels/csrc/hstu_attention_bwd.cu`` once as it is
and once for each ablation, each variant with its own copy of the source
and of the header it includes (``hstu_fwd_tile.cuh``) under
``build/ablations_bwd/``, and prints each variant's device time per call
(``chip_smoke.device_ms``) of B2 (its wrapper, with the drab partials'
sum) and B3 at the hstu-gr training shape (B 32, H 2, S 80, D 32, rab) and
the roo-lsr ``userarch_hstu`` step's (B 32, S 64, causal), beside an empty
launch and the drab partials' sum alone. The ablations give wrong outputs
on purpose; only "as built" is the kernel. They are:

  no mma       the tensor-core products replaced by a few adds
  1xTF32       hi*hi only (one mma a product instead of three)
  no drab      B2 without the ds staging, diagonal sums and fold
  no tiles     no tile is multiplied: launch, lengths, copies, barriers,
               the split's sum, the drab fold and the stores only

Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablations_bwd"
SOURCE, HEADER = "hstu_attention_bwd.cu", "hstu_fwd_tile.cuh"
MMA = '  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "'


def variants(source: str, header: str) -> dict:
    """{name: (source, header)}; each edit must still apply."""
    edits = {
        "no mma": (HEADER, MMA, "  c[0] += __uint_as_float(a[0] ^ b[0]);\n"
                                "  c[2] += __uint_as_float(a[2] ^ b[1]);\n"
                                "  if (0)" + MMA[1:]),
        "1xTF32": (HEADER, "  mma_tf32(c, a.lo, bh);\n"
                           "  mma_tf32(c, a.hi, bl);\n", ""),
        "no drab": (SOURCE, "const bool fold = !DKV && use_rab;",
                    "const bool fold = false;"),
        "no tiles": (SOURCE, "const bool warp_live = live(ct, wr0, wr_last);",
                     "const bool warp_live = ct < 0;"),
    }
    out = {"as built": (source, header)}
    for name, (which, old, new) in edits.items():
        text = source if which == SOURCE else header
        if old not in text:
            raise SystemExit(f"ablation {name!r}: its edit no longer applies")
        text = text.replace(old, new)
        out[name] = (text, header) if which == SOURCE else (source, text)
    return out


def build(name: str, texts, nvcc: str, flags) -> Path:
    d = OUT / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCE).write_text(texts[0])
    (d / HEADER).write_text(texts[1])
    lib = d / "hstu_attention_bwd.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(d / SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hstu_bwd_ablations: needs the card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import hstu_attention as kmod
    from repro_torch.kernels import hstu_attention_bwd as bmod
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    found = variants((CSRC / SOURCE).read_text(), (CSRC / HEADER).read_text())
    nvcc = kmod._nvcc()
    with ThreadPoolExecutor(len(found)) as pool:
        libs = dict(zip(found, pool.map(
            lambda kv: build(*kv, nvcc, kmod.NVCC_FLAGS), found.items())))

    def bind(path: Path) -> None:
        """bmod's own binding (``_load``), on this variant's library."""
        built = bmod.build
        bmod._lib, bmod.build = None, lambda: (path, "")
        try:
            bmod._load()
        finally:
            bmod.build = built

    def args(shape, causal):
        x = cs.attention_inputs(shape, seed=0, device=dev)
        if causal:
            x["tc"].zero_()
        g = torch.randn(x["v"].shape, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        return (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["hl"],
                x["tc"], x["max_rel"], g)

    cases = {}
    for label, shape, causal in (
            ("train", (32, 2, 80, 32, 32, 64, 64), False),
            ("userarch_hstu", (32, 2, 64, 32, 32, 64, 64), True)):
        a = args(shape, causal)
        cases[f"B2 {label}"] = (bmod.hstu_attention_bwd_dq_cuda, a)
        cases[f"B3 {label}"] = (bmod.hstu_attention_bwd_dkv_cuda, a)
    bind(libs["as built"])
    rows = bmod.rows_per_block(64, 80)
    part = torch.randn(2, 129, 32 * -(-80 // rows), device=dev)
    print(f"[ablations] {cs.card_line()}: device ms per call "
          f"(chip_smoke.device_ms, 200 calls); empty launch "
          f"{cs.device_ms(lambda: torch.cuda._sleep(0), 200):.5f} ms; the "
          f"drab partials' sum alone (train, {tuple(part.shape)}, last "
          f"axis) {cs.device_ms(lambda: part.sum(-1), 200):.5f} ms")
    for rnd in (1, 2):
        for name, path in libs.items():
            bind(path)
            times = {case: cs.device_ms(lambda: fn(*a), 200)
                     for case, (fn, a) in cases.items()}
            print(f"[ablations] round {rnd} {name:9s} " + ", ".join(
                f"{case} {ms:.5f}" for case, ms in times.items()))
    bmod._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
