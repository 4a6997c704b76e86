"""How ``correct`` is decided: what the timed path produced for a sample of
requests, held against the plain reference: the sample's rules and the
collected rows (``servebench/reference/sample.py``) and the
configuration's architecture (``servebench/reference/<arch>.py``).

Numbers compared, each with its limit (``limits`` in the configuration
file, or 0 for an exact comparison):

* ``unanswered``: requests that raised or never answered (limit 0);
* ``uncaptured``: sampled requests whose timed-path output was not kept
  (limit 0);
* ``hops_invalid``: sampled slots that break the sampler's rules
  (limit 0);
* ``feature_mismatch``: elements of the sampled collected rows that are
  not bit for bit the feature table's row (limit 0; a copy);
* ``agg_err``: largest absolute gap of the sampled innermost sums
  (``lookup_aggregate``) from the reference's float32 sum;
* ``embed_err``: largest absolute gap of a served embedding from the
  architecture's float32 reference over the same sample.
"""
from __future__ import annotations

import torch

from servebench.reference import sample


def compare(ref, cfg: dict, graph, feats_np, weights_np, items: list,
            device: torch.device, *, control: bool = False) -> dict:
    """Readings over ``items``, each ``(seeds, result, records)`` (records
    ``None`` when nothing was captured); ``ref`` is the architecture's
    reference (``weights_on``, ``embed``). With ``control`` the reference
    in the next precision below stands in the program's place: TF32 matrix
    products for the model (``control_embed_err``), bfloat16 sums for the
    innermost aggregation (``control_agg_err``)."""
    sample.no_tf32()
    fanouts = list(cfg["fanouts"])
    g = sample.Graph(graph.indptr, graph.indices, graph.num_nodes, device)
    feats = torch.as_tensor(feats_np, device=device)
    w = ref.weights_on(weights_np, device)
    out = {"uncaptured": 0, "hops_invalid": 0, "feature_mismatch": 0,
           "agg_err": 0.0, "embed_err": 0.0}
    if control:
        out["control_embed_err"] = 0.0
    for seeds, result, records in items:
        if not records:
            out["uncaptured"] += 1
            continue
        seeds_t = torch.as_tensor(seeds)
        lo = 0
        for rec in records:
            chunk = min(int(rec.hops[0].shape[0]), int(seeds_t.shape[0]) - lo)
            out["hops_invalid"] += sample.invalid_hops(
                g, rec.hops, seeds_t[lo:lo + chunk], fanouts)
            for k, (pos, got) in enumerate(zip(rec.feat_pos, rec.feat_rows)):
                want = sample.rows(feats, rec.hops[k][pos])
                out["feature_mismatch"] += int(
                    (got.to(device) != want).sum())
            if rec.agg_pos is not None:
                fan = fanouts[-1]
                parents = rec.hops[-2][rec.agg_pos]
                child = rec.hops[-1].view(-1, fan)[rec.agg_pos].reshape(-1)
                want = sample.fan_sums(feats, parents, child, fan)
                gap = (rec.agg_rows.to(device) - want).abs().max()
                out["agg_err"] = max(out["agg_err"], float(gap))
                if control:
                    ctl = sample.fan_sums(feats, parents, child, fan,
                                          bf16=True)
                    out["control_agg_err"] = max(
                        out.get("control_agg_err", 0.0),
                        float((ctl - want).abs().max()))
            want = ref.embed(w, feats, rec.hops, fanouts)[:chunk]
            got = torch.as_tensor(result[lo:lo + chunk]).to(device)
            out["embed_err"] = max(out["embed_err"],
                                   float((got - want).abs().max()))
            if control:
                ctl = ref.embed(w, feats, rec.hops, fanouts, tf32=True)
                out["control_embed_err"] = max(
                    out["control_embed_err"],
                    float((ctl[:chunk] - want).abs().max()))
            lo += chunk
        if lo != int(seeds_t.shape[0]):
            out["uncaptured"] += 1
    return out


def judge(readings: dict, unanswered: int, limits: dict) -> list:
    """``[(name, value, limit)]`` of every number compared, in print
    order."""
    rows = [("unanswered", unanswered, 0),
            ("uncaptured", readings["uncaptured"], 0),
            ("hops_invalid", readings["hops_invalid"], 0),
            ("feature_mismatch", readings["feature_mismatch"], 0)]
    if "agg_err" in limits:
        rows.append(("agg_err", readings["agg_err"], limits["agg_err"]))
    rows.append(("embed_err", readings["embed_err"], limits["embed_err"]))
    return rows


def passed(rows: list) -> bool:
    return all(value <= limit for _, value, limit in rows)
