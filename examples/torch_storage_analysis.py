"""Storage walk-through (paper §2.1 + Table 4) on the PyTorch port: how the
request-level schema removes duplication at the source, per column group.

The port of ``examples/storage_analysis.py``: the same stream, joins and
column encoders (``repro_torch.data.storage``), so it prints the same
table. No model runs, so ``--device`` changes nothing here; it is taken
for the same command line as the other ``torch_*`` examples.

Run:  PYTHONPATH=src python examples/torch_storage_analysis.py
"""
import argparse
import random

from repro_torch.core.joiner import ImpressionLevelJoiner, RequestLevelJoiner
from repro_torch.data.events import EventSimulator, EventStreamConfig
from repro_torch.data.storage import (encode_impression_table,
                                      encode_roo_table,
                                      sample_volume_increase)

N_REQUESTS = 300
HIST_INIT_MAX = 200
PRODUCT = "product_b"
COLUMNS = ("ro_dense", "ro_idlist", "history", "item_dense", "item_idlist",
           "labels", "total")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="accepted for a common command line; unused")
    ap.parse_args(argv)

    cfg = EventStreamConfig(n_requests=N_REQUESTS, product=PRODUCT,
                            hist_init_max=HIST_INIT_MAX, seed=0)
    roo = RequestLevelJoiner().join(list(EventSimulator(cfg).stream()))
    imp = ImpressionLevelJoiner().join(list(EventSimulator(cfg).stream()))
    random.Random(0).shuffle(imp)
    random.Random(0).shuffle(roo)

    n_imp = len(imp)
    ci = encode_impression_table(imp)
    cr = encode_roo_table(roo)
    print(f"{n_imp} impressions in {len(roo)} requests "
          f"({n_imp / len(roo):.1f} per request)\n")
    print(f"{'column':<14}{'impression-level':>18}{'request-level':>16}"
          f"{'saving':>9}")
    table = {}
    for k in COLUMNS:
        a, b = ci.get(k, 0), cr.get(k, 0)
        save = 100 * (1 - b / a) if a else 0.0
        table[k] = (a, b, save)
        print(f"{k:<14}{a:>16}B {b:>14}B {save:>7.1f}%")
    res = sample_volume_increase(imp, roo)
    print(f"\n=> {res['sample_volume_increase_pct']:.0f}% more training "
          f"samples in the same storage (paper Table 4: 43-150%)")
    return {"n_impressions": n_imp, "n_requests": len(roo),
            "columns": table,
            "sample_volume_increase_pct": res["sample_volume_increase_pct"]}


if __name__ == "__main__":
    main()
