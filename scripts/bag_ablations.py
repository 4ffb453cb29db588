#!/usr/bin/env python3
"""What the embedding-bag kernels' design choices (B5, B6) are worth.

Run from the repo root on a machine with one NVIDIA H100:

    python3 scripts/bag_ablations.py

Builds ``src/repro_torch/kernels/csrc/embedding_bag.cu`` once as it is and
once for each variant below (each a copy of the source under
``build/ablations/bag/``), checks that every variant gives the same bits
as the source, and prints each variant's device time per call
(``chip_smoke.device_ms``) at dlrm-mlperf's NRO side (13 one-hot fields,
vocabs capped as ``chip_smoke.DLRM_CAP``, D 128) at its training (B 8,192)
and scoring (B 512) batches, and at the LSR history bag (mean, L 64, D 64,
one field of 50,000 rows) in fp32 and bf16 at B 32 (training), 64
(serving), 192 (impression-level), 512, 2,048 and 8,192, with the launch
(``embedding_bag.fwd_plan``) each LSR case took. The variants change how
fast, not what:

  no deep kernel       long bags take the 16-byte path, 8 rows ahead, in
                       blocks of four warps (B5's launch before the deep
                       kernel; as built: the deep kernel for rows of 128
                       bytes or more)
  deep U 16 / 32       the deep kernel stages 16 or 32 slots a round (as
                       built: 64)
  deep 8- / 16-byte lanes  the deep kernel's lanes add 8 or 16 bytes of a
                       row (as built: the narrowest of 4, 8 and 16 that
                       covers a row in one pass of the warp)
  depth 4 / 8 / 16     every bag, short or long, on the 16-byte path 4, 8
                       or 16 rows ahead (as built: all of a short bag's)
  one element a lane   the 16-byte loads and stores off (and the deep
                       kernel with them)
  one warp a block     blocks of 32 threads on the short, long and B6
                       paths (as built: 128; the deep kernel's are 32)

Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "embedding_bag.cu"
OUT = ROOT / "build" / "ablations" / "bag"

PATHS = "if (L <= kShortBag || widest != 16 || row < kDeepRow)"
SHORT = "L <= kShortBag ? kShort : kLong"
LONG = "constexpr int kLongBag = 8;"
DEEP = "constexpr int kDeepBag = 64;"
DEEP_ROW = "constexpr int kDeepRow = 128;"
NARROW = "while (bytes > 4 && row / (bytes / 2) <= 32) bytes /= 2;"
VEC_FWD = "bool vec = grp.D % (16 / sizeof(T)) == 0 && aligned16(out);"
VEC_BWD = "const bool vec = grp.D % kVec == 0 && aligned16(g) && aligned16(rows);"


def depth(n: int) -> list:
    return [(PATHS, "if (true)"), (SHORT, "kLong"),
            (LONG, f"constexpr int kLongBag = {n};")]


EDITS = {
    "no deep kernel": [(DEEP_ROW, "constexpr int kDeepRow = 1 << 30;")],
    "deep U 16": [(DEEP, "constexpr int kDeepBag = 16;")],
    "deep U 32": [(DEEP, "constexpr int kDeepBag = 32;")],
    "deep 8-byte lanes": [(NARROW, NARROW.replace("bytes > 4",
                                                  "bytes > 8"))],
    "deep 16-byte lanes": [(NARROW, "")],
    "depth 4": depth(4),
    "depth 8": depth(8),
    "depth 16": depth(16),
    "one element a lane": [(VEC_FWD, "bool vec = false;"),
                           (VEC_BWD, "const bool vec = false;")],
    "one warp a block": [("constexpr int kThreads = 128;",
                          "constexpr int kThreads = 32;")],
}
LSR_BATCHES = (32, 64, 192, 512, 2048, 8192)


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
        print("bag_ablations: needs the card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import embedding_bag as emod
    from repro_torch.kernels.hstu_attention import build_library
    dev = torch.device("cuda", 0)
    paths = {}
    for name, text in variants(SOURCE.read_text()).items():
        d = OUT / name.replace(" ", "_").replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "embedding_bag.cu").write_text(text)
        paths[name] = d / "embedding_bag.cu"
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(build_library, paths.values()))
    libs = {}
    for name, path in paths.items():
        emod.SOURCE, emod._lib = path, None
        libs[name] = emod._load()
    emod.SOURCE, emod._lib = SOURCE, None

    gen = torch.Generator(device=dev).manual_seed(5)
    vocabs = cs.dlrm_side_vocabs("nro")
    tables = [0.01 * torch.randn((v, 128), generator=gen, device=dev)
              for v in vocabs]

    def dlrm(b):
        ids = torch.stack([torch.randint(0, v, (b, 1), generator=gen,
                                         device=dev, dtype=torch.int32)
                           for v in vocabs], 1)
        lens = torch.ones((b, 13), dtype=torch.int32, device=dev)
        g = torch.randn((b, 13, 128), generator=gen, device=dev)
        return ids, lens, g

    (ti, tl, tg), (si, sl, _) = dlrm(8192), dlrm(512)
    cases = {
        "B5 dlrm train NRO B8192 F13": lambda: emod.
        embedding_bag_grouped_fwd_cuda(tables, ti, tl),
        "B5 dlrm score NRO B512 F13": lambda: emod.
        embedding_bag_grouped_fwd_cuda(tables, si, sl),
    }
    lsr_shapes = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for b in LSR_BATCHES:
            x = cs.bag_inputs((b, 64, 64, 50000), 9, dev, dtype=dtype)
            key = f"B5 LSR {tag} B{b} L64 mean"
            lsr_shapes[key] = (b, dtype)
            cases[key] = (lambda x=x: emod.embedding_bag_fwd_cuda(
                x["table"], x["ids"], x["lens"], "mean"))
            if b == 32:
                cases[f"B6 LSR {tag} B32 L64 mean"] = (
                    lambda x=x: emod.embedding_bag_coo_rows_cuda(
                        x["g"], x["ids"], x["lens"], 50000, "mean"))
    cases["B6 dlrm train NRO B8192 F13"] = (
        lambda: emod.embedding_bag_grouped_coo_rows_cuda(tg, ti, tl, vocabs))
    emod._lib = libs["as built"]
    want = {case: fn() for case, fn in cases.items()}
    for name, lib in libs.items():
        emod._lib = lib
        for case, fn in cases.items():
            got = fn()
            same = (all(torch.equal(a, b) for a, b in zip(got, want[case]))
                    if isinstance(got, tuple) else torch.equal(got,
                                                               want[case]))
            if not same:
                raise SystemExit(f"{name}: {case} differs from the source")
    print(f"[bag ablations] {cs.card_line()}: device ms per call "
          f"(chip_smoke.device_ms, 200 calls); every variant equal to the "
          f"source bit for bit")
    for name, lib in libs.items():
        emod._lib = lib
        plans = ", ".join(
            f"{key[7:]} {tuple(emod.fwd_plan(1, b, 64, 64, dt).values())}"
            for key, (b, dt) in lsr_shapes.items())
        print(f"[bag ablations] {name}: launches (vec, u, threads, blocks, "
              f"lanes): {plans}")
    for rnd in (1, 2):
        for name, lib in libs.items():
            emod._lib = lib
            times = {case: cs.device_ms(fn, 200)
                     for case, fn in cases.items()}
            print(f"[bag ablations] round {rnd} {name:22s} " + ", ".join(
                f"{case} {ms:.5f}" for case, ms in times.items()))
    emod._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
