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
and scoring (B 512) batches and at the LSR history bag (mean, L 64, D 64,
one field) at B 32 and B 192. The variants change how fast, not what:

  depth 4 / 8 / 16   every bag loads its rows 4, 8 or 16 slots ahead of
                     their adds (as built: all of a bag up to L 4, else 8)
  ids behind a branch  a long bag's ids read only for slots < len, one
                     branch each (as built: read at min(l, len - 1), no
                     branch; a short bag is one round and reads < len)
  one element a lane   the 16-byte loads and stores off
  one warp a block     blocks of 32 threads (as built: 128), so a small
                     grid spreads over more SMs

Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "embedding_bag.cu"
OUT = ROOT / "build" / "ablations" / "bag"

SHORT = "  if (grp.L <= kShortBag)"
LONG = "constexpr int kLongBag = 8;"
IDS0 = "id[j] = clip_id(bag[min(j, last) * sl], V);"
IDS = "id[j] = clip_id(bag[min(base + U + j, last) * sl], V);"
VEC_FWD = "bool vec = grp.D % kVec == 0 && aligned16(out);"
VEC_BWD = "const bool vec = grp.D % kVec == 0 && aligned16(g) && aligned16(rows);"
EDITS = {
    "depth 4": [(SHORT, "  if (false)"), (LONG, "constexpr int kLongBag = 4;")],
    "depth 8": [(SHORT, "  if (false)")],
    "depth 16": [(SHORT, "  if (false)"),
                 (LONG, "constexpr int kLongBag = 16;")],
    "ids behind a branch": [
        (IDS0, "if (j < n) id[j] = clip_id(bag[j * sl], V);"),
        (IDS, "if (base + U + j < n) id[j] = "
              "clip_id(bag[(base + U + j) * sl], V);")],
    "one element a lane": [(VEC_FWD, "bool vec = false;"),
                           (VEC_BWD, "const bool vec = false;")],
    "one warp a block": [("constexpr int kThreads = 128;",
                          "constexpr int kThreads = 32;")],
}


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
        d = OUT / name.replace(" ", "_")
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

    def lsr(b):
        x = cs.bag_inputs((b, 64, 64, 50000), 9, dev)
        return x["table"], x["ids"], x["lens"], x["g"]

    (ti, tl, tg), (si, sl, _) = dlrm(8192), dlrm(512)
    lt, li, ll, lg = lsr(32)
    it, ii, il, _ = lsr(192)
    cases = {
        "B5 dlrm train NRO B8192 F13": lambda: emod.
        embedding_bag_grouped_fwd_cuda(tables, ti, tl),
        "B5 dlrm score NRO B512 F13": lambda: emod.
        embedding_bag_grouped_fwd_cuda(tables, si, sl),
        "B5 LSR B32 L64 mean": lambda: emod.embedding_bag_fwd_cuda(
            lt, li, ll, "mean"),
        "B5 LSR B192 L64 mean": lambda: emod.embedding_bag_fwd_cuda(
            it, ii, il, "mean"),
        "B6 dlrm train NRO B8192 F13": lambda: emod.
        embedding_bag_grouped_coo_rows_cuda(tg, ti, tl, vocabs),
        "B6 LSR B32 L64 mean": lambda: emod.embedding_bag_coo_rows_cuda(
            lg, li, ll, 50000, "mean"),
    }
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
    for rnd in (1, 2):
        for name, lib in libs.items():
            emod._lib = lib
            times = {case: cs.device_ms(fn, 200)
                     for case, fn in cases.items()}
            print(f"[bag ablations] round {rnd} {name:19s} " + ", ".join(
                f"{case} {ms:.5f}" for case, ms in times.items()))
    emod._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
