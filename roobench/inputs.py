"""Inputs for the drivers, drawn by the laws of a traffic file
(``roobench/traffic.py``) from ``--seed``: dlrm field batches and hstu-gr
requests. Nothing here imports the program, except where a request has to
be handed to it in its own type (``ROOSample``)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from roobench import traffic as T
from roobench import yardstick as Y


def _field_perms(g, rows: List[int]):
    """One seeded affine permutation per field: the same ids are popular in
    every batch of a run."""
    return [T.affine_permutation(g, r) for r in rows]


def dlrm_pool(seed: int, cfg: dict, tr: dict) -> List[Dict]:
    """``tr["pool_batches"]`` request-only dlrm batches of exactly
    ``tr["impressions_per_step"]`` impression slots: request sizes, dense
    features, one id a field (Zipf over the rows held here), labels.

    Each batch is a dict of numpy arrays in the program's field-batch
    format (``ro_dense``, ``ro_ids``, ``ro_len``, ``nro_ids``, ``nro_len``,
    ``seg``, ``y``) plus ``_info``: B_RO, the distinct ids of each field
    and the yardstick's FLOPs and bag bytes of the batch."""
    rows, n_ro = cfg["vocabs"], cfg["n_ro_fields"]
    mh, d = cfg["multi_hot"], cfg["embed_dim"]
    perms = _field_perms(T.rng(seed, 11), rows)
    slots = int(tr["impressions_per_step"])
    out = []
    for j in range(int(tr["pool_batches"])):
        g = T.rng(seed, 12, j)
        sizes = T.request_sizes(tr["impressions_per_request"], g, slots)
        b_ro = len(sizes)
        seg = np.repeat(np.arange(b_ro, dtype=np.int32), sizes)
        ro_ids = np.stack([
            T.zipf_ids(tr["ids"], g, b_ro * mh, rows[f], perms[f]).reshape(
                b_ro, mh) for f in range(n_ro)], axis=1).astype(np.int32)
        nro_ids = np.stack([
            T.zipf_ids(tr["ids"], g, slots * mh, rows[f], perms[f]).reshape(
                slots, mh) for f in range(n_ro, len(rows))],
            axis=1).astype(np.int32)
        batch = {
            "ro_dense": T.draw(tr["dense"], g, b_ro * cfg["n_dense"]).reshape(
                b_ro, cfg["n_dense"]),
            "ro_ids": ro_ids,
            "ro_len": np.full((b_ro, n_ro), mh, np.int32),
            "nro_ids": nro_ids,
            "nro_len": np.full((slots, len(rows) - n_ro), mh, np.int32),
            "seg": seg,
            "y": T.draw(tr["labels"], g, slots)}
        distinct = [len(np.unique(ro_ids[:, f])) for f in range(n_ro)] + [
            len(np.unique(nro_ids[:, f])) for f in range(len(rows) - n_ro)]
        n_ro_f, n_nro_f = n_ro, len(rows) - n_ro
        b5 = (Y.bag_fwd_bytes(sum(distinct[:n_ro]), b_ro * n_ro_f * mh,
                              b_ro * n_ro_f, d)
              + Y.bag_fwd_bytes(sum(distinct[n_ro:]), slots * n_nro_f * mh,
                                slots * n_nro_f, d))
        b6 = (Y.bag_bwd_bytes(b_ro * n_ro_f * mh, b_ro * n_ro_f, d)
              + Y.bag_bwd_bytes(slots * n_nro_f * mh, slots * n_nro_f, d))
        batch["_info"] = {
            "b_ro": b_ro, "b_nro": slots,
            "train_flops": Y.dlrm_train_flops(cfg, b_ro, slots),
            "fwd_flops": Y.dlrm_fwd_flops(cfg, b_ro, slots),
            "b5_bytes": b5, "b6_bytes": b6}
        out.append(batch)
    return out


def field_ids(batch: Dict, cfg: dict, f: int) -> np.ndarray:
    """The valid ids of sparse field ``f`` in a pool batch."""
    n_ro = cfg["n_ro_fields"]
    if f < n_ro:
        ids, lens = batch["ro_ids"][:, f], batch["ro_len"][:, f]
    else:
        ids, lens = batch["nro_ids"][:, f - n_ro], batch["nro_len"][:, f - n_ro]
    valid = np.arange(ids.shape[1])[None, :] < lens[:, None]
    return ids[valid]


class GRTraffic:
    """Open-loop hstu-gr requests: arrival offsets, and for each request a
    history (from a pool of ``history_pool`` distinct ones), its actions
    and its targets. Every request is a new user."""

    def __init__(self, seed: int, cfg: dict, tr: dict, n_requests: int,
                 rate_per_s: float):
        window = cfg["hist_len"]
        g = T.rng(seed, 21)
        n_pool = int(tr["history_pool"])
        lens = T.draw(tr["history_len"], g, n_pool)
        kept = np.minimum(lens, window)
        item_perm = T.affine_permutation(g, cfg["n_items"])
        self.hist_ids, self.hist_acts = [], []
        for k in kept:
            ids = T.zipf_ids(tr["item_ids"], g, int(k), cfg["n_items"],
                            item_perm)
            acts = T.draw(tr["actions"], g, int(k))
            self.hist_ids.append(ids.tolist())
            self.hist_acts.append(acts.tolist())
        g = T.rng(seed, 22)
        self.due = T.draw({"law": "poisson", "rate_per_s": rate_per_s}, g,
                          n_requests)
        self.pool_of = g.permutation(n_requests) % n_pool
        self.n_imps = T.draw(tr["impressions_per_request"], g, n_requests)
        self.item_ids = [
            T.zipf_ids(tr["item_ids"], g, int(n), cfg["n_items"],
                      item_perm).tolist() for n in self.n_imps]
        self.n_requests = n_requests

    def hist_len(self, i: int) -> int:
        return len(self.hist_ids[self.pool_of[i]])

    def sample(self, i: int, request_id: int):
        """Request ``i`` as the program's ``ROOSample`` (a new user)."""
        from repro_torch.core.joiner import ROOSample
        p = self.pool_of[i]
        n = int(self.n_imps[i])
        return ROOSample(
            request_id=request_id, user_id=request_id, ro_dense=_ZERO,
            ro_idlist=[], history_ids=self.hist_ids[p],
            history_actions=self.hist_acts[p], item_ids=self.item_ids[i],
            item_dense=[_ZERO] * n, item_idlist=[[]] * n, labels=[{}] * n)


_ZERO = np.zeros((1,), np.float32)
