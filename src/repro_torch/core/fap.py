"""Feature Access Probability (FAP) — paper §5.1, on the device.

    P_K = Σ_{k=0..K} w_k,   w_0 = p_0,   w_k = Tᵀ w_{k-1}

computed with K transposed SpMV passes (``segment_sum_ordered``: each
node's terms in edge order, so the card gives the CPU's bits).
``truncated`` damps each step by the fanout acceptance ratio
``min(deg, l_k)/deg``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.psgs import _coo
from repro_torch.graph.segment import segment_sum_ordered


def compute_fap(graph, fanouts: Sequence[int], *,
                seed_prob: Optional[np.ndarray] = None,
                truncated: bool = False,
                device: str | torch.device = "cuda") -> np.ndarray:
    """FAP lookup table P_K, shape ``(num_nodes,)``, float32."""
    dev = resolve_device(device)
    n = graph.num_nodes
    if seed_prob is None:
        p0 = np.full((n,), 1.0 / n, dtype=np.float32)
    else:
        p0 = np.asarray(seed_prob, dtype=np.float32)
        p0 = p0 / max(p0.sum(), 1e-12)
    src, dst, deg, inv_deg = _coo(graph, dev)
    w = torch.as_tensor(p0, device=dev)
    total = w
    for l_k in fanouts:
        rate = deg.clamp_max(float(l_k)) * inv_deg if truncated else inv_deg
        w = segment_sum_ordered((w * rate)[src], dst, n)
        total = total + w
    return total.cpu().numpy()
