#!/usr/bin/env python3
"""What the dot-interaction kernel's design choices (B7) are worth.

Run from the repo root on a machine with one NVIDIA H100:

    python3 scripts/dot_ablations.py

Builds ``src/repro_torch/kernels/csrc/dot_interaction.cu`` once as it is
and once for each variant below (each a copy of the source under
``build/ablations/dot/``), checks every variant that computes the same
function against the plain version (and, where its arithmetic is the
source's, bit for bit against the source), and prints each variant's
device time per call (``chip_smoke.device_ms``) at dlrm-mlperf's training
(B 8,192) and scoring (B 512) shapes, F 26, D 128, fp32:

  one TF32 pass        hi·hi alone (time only: it misses the fp32 gate)
  one accumulator      every mma accumulates into the running sum (as
                       built: a k-step's products in a fresh fragment,
                       added to the sum with one rounded fp32 add)
  no k split           one warp a sample at every batch (as built: up to
                       4 at a small batch, 4 at B 512)
  one warp a block     blocks of one warp, no k split (as built: 4 warps)
  no loads ahead       each 16-column chunk loaded just before its products
                       (as built: 1 chunk ahead)
  4-byte loads only    one element a load (as built: 16 bytes a lane)
  no L2 line hint      plain 16-byte loads (as built: each asks L2 for its
                       128-byte line, ld.global.nc.L2::128B)
  loads and splits only  the products and their adds cut out, the loads
                       and the hi / lo splits kept (time only)
  empty launch         the kernel returns at once: the launch alone

Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
          "dot_interaction.cu")
OUT = ROOT / "build" / "ablations" / "dot"

PRODUCTS = "if (8 * c >= F1) continue;  // warp-uniform"
EDITS = {
    "one TF32 pass": [("constexpr int kFp32Passes = 3;",
                       "constexpr int kFp32Passes = 1;")],
    "one accumulator": [("constexpr bool kStepPartials = true;",
                         "constexpr bool kStepPartials = false;")],
    "no k split": [("constexpr int kMaxSplit = 4;",
                    "constexpr int kMaxSplit = 1;")],
    "one warp a block": [("constexpr int kMaxSamples = 4;",
                          "constexpr int kMaxSamples = 1;"),
                         ("constexpr int kMaxSplit = 4;",
                          "constexpr int kMaxSplit = 1;")],
    "no loads ahead": [("constexpr int kAhead = 1;",
                        "constexpr int kAhead = 0;")],
    "4-byte loads only": [("constexpr bool kVecLoads = true;",
                           "constexpr bool kVecLoads = false;")],
    "no L2 line hint": [("constexpr bool kL2Lines = true;",
                         "constexpr bool kL2Lines = false;")],
    "loads and splits only": [(PRODUCTS, (
        "if (true) {  // keeps every load and split alive\n"
        "                acc[0][0] += __uint_as_float(\n"
        "                    hi[r][0] ^ hi[r][1] ^ hi[r][2] ^ hi[r][3] ^\n"
        "                    (PASSES == 3 ? lo[r][0] ^ lo[r][1] ^ lo[r][2] ^"
        " lo[r][3] : 0u));\n"
        "                continue;\n"
        "              }"))],
    "empty launch": [("  constexpr int NT = RB * (RB + 1);       // lower",
                      "  if (B > 0) return;\n"
                      "  constexpr int NT = RB * (RB + 1);       // lower")],
}
# the same arithmetic in the same order as the source: equal bit for bit
SAME_BITS = ("no loads ahead", "4-byte loads only", "no L2 line hint")
TIME_ONLY = ("one TF32 pass", "loads and splits only", "empty launch")


def variants(text: str) -> dict:
    out = {"as built": text}
    for name, edits in EDITS.items():
        v = text
        for old, new in edits:
            if old not in v:
                raise SystemExit(f"variant {name!r}: its edit no longer "
                                 f"applies")
            v = v.replace(old, new)
        out[name] = v
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dot_ablations: needs the card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import dot_interaction as dmod
    from repro_torch.kernels.hstu_attention import build_library
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    paths = {}
    for name, text in variants(SOURCE.read_text()).items():
        d = OUT / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "dot_interaction.cu").write_text(text)
        # the source includes the shared tile header by a relative path
        (d / "hstu_fwd_tile.cuh").write_text(
            (SOURCE.parent / "hstu_fwd_tile.cuh").read_text())
        paths[name] = d / "dot_interaction.cu"
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(build_library, paths.values()))
    libs = {}
    for name, path in paths.items():
        dmod.SOURCE, dmod._lib = path, None
        libs[name] = dmod._load()
    dmod.SOURCE, dmod._lib = SOURCE, None

    inputs = {key: cs.dot_inputs(cs.DOT_SHAPES[name], 100, dev)
              for key, name in (("train B8192", "train B8192 F26 D128"),
                                ("score B512", "score B512 F26 D128"))}
    cases = {key: (lambda x=x: dmod.dot_interaction_cuda(*x))
             for key, x in inputs.items()}
    plain = {key: dmod.dot_interaction_plain(*x) for key, x in inputs.items()}
    dmod._lib = libs["as built"]
    want = {case: fn() for case, fn in cases.items()}
    for name, lib in libs.items():
        if name in TIME_ONLY:
            continue
        dmod._lib = lib
        for case, fn in cases.items():
            got = fn()
            ok = bool(torch.all((got - plain[case]).abs() <= cs.DOT_ATOL
                                + cs.DOT_RTOL * plain[case].abs()))
            if not ok or (name in SAME_BITS and not torch.equal(
                    got, want[case])):
                raise SystemExit(f"{name}: {case} disagrees with the plain "
                                 f"version or the source's bits")
    print(f"[dot ablations] {cs.card_line()}: device ms per call "
          f"(chip_smoke.device_ms, 200 calls); every variant but "
          f"{', '.join(TIME_ONLY)} within the gate of the plain version, "
          f"{', '.join(SAME_BITS)} bit for bit the source's")
    for name in ("as built", "one accumulator", "one TF32 pass"):
        dmod._lib = libs[name]
        err = {case: float((fn() - plain[case]).abs().max())
               for case, fn in cases.items()}
        print(f"[dot ablations] {name}: max|B7-plain| " + ", ".join(
            f"{c} {e:.3e}" for c, e in err.items()))
    for rnd in (1, 2):
        for name, lib in libs.items():
            dmod._lib = lib
            times = {case: cs.device_ms(fn, 200)
                     for case, fn in cases.items()}
            print(f"[dot ablations] round {rnd} {name:21s} " + ", ".join(
                f"{case} {ms:.5f}" for case, ms in times.items()))
    dmod._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
