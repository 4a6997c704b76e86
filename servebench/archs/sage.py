"""GraphSAGE (mean aggregator, LayerNorm a layer) as the port serves it:
``models/gnn_basic.py``'s ``sage_layered`` behind the serve launcher's
``make_infer_fn``. The architecture ``"arch": "sage"`` of a
configuration; its plain reference is ``servebench/reference/sage.py``.

The configuration gives ``feat_dim``, ``hidden`` (one width a hidden
layer), ``classes`` and ``fanouts`` (one hop a layer).
"""
from __future__ import annotations

import torch

from servebench import costs, inputs

# GraphSAGE takes the innermost hop as its children's rows or as their
# sums (``lookup_aggregate``): the mean needs only the sum and the count
COLLECTS = ("lookup_hops", "lookup_aggregate")

# what the host span ``model`` wraps
MODEL_SPAN = ("repro_torch.models.gnn_basic", "sage_layered")


def dims(cfg: dict) -> list:
    return [cfg["feat_dim"], *cfg["hidden"], cfg["classes"]]


def weights(cfg: dict, seed: int, device: torch.device) -> dict:
    """The numpy weight tree drawn from ``seed`` (``inputs.sage_weights``)."""
    return inputs.sage_weights(dims(cfg), seed, device)


def infer_fn(cfg: dict, weights: dict, device: torch.device):
    """The port's ``infer_fn(hop_feats, hop_ids, deep_agg=None)`` over
    ``weights``."""
    from repro_torch.launch.serve import make_infer_fn
    from repro_torch.models.gnn_basic import sage_from_numpy

    return make_infer_fn(sage_from_numpy(weights, device=device),
                         tuple(cfg["fanouts"]))


def flops_per_seed(cfg: dict) -> int:
    """Model FLOPs of one unpadded seed (``costs.sage_flops_per_seed``)."""
    return costs.sage_flops_per_seed(dims(cfg), cfg["fanouts"])
