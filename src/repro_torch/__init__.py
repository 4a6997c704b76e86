"""PyTorch/CUDA port of the Quiver serving system for one NVIDIA H100.

The package mirrors ``src/repro`` module for module (``graph``, ``core``,
``kernels``, ``models``, ``configs``, ``serving``, ``launch``) and imports
only ``torch``, numpy and the standard library: nothing of JAX and nothing
of the ``repro`` reference package, so it runs where JAX is absent. The
Pallas kernels of the ported paths (``tiered_gather`` and
``gather_aggregate`` for GNN serving, ``embedding_bag`` for DIN serving,
``segment_spmm`` for GIN training, ``flash_attention`` for LM prefill)
are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use (see :mod:`repro_torch.kernels.build`).

Entry points take ``device=`` and default to ``"cuda"``. Asking for
``"cuda"`` where no card is present raises; nothing silently carries on on
the CPU. Tests pass ``device="cpu"`` explicitly, and there every kernel
wrapper takes its plain PyTorch version.

Numerics: importing the package switches TF32 off for both cuBLAS
(``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
(``torch.backends.cudnn.allow_tf32``), so float32 matrix products run in
full float32 and the card's model outputs stay within fp32 tolerance of
the CPU and of the JAX reference. It also forbids cuBLAS to reduce bf16
products in bf16 (``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction``): the LM's bf16 GEMMs sum in
fp32 as on the CPU, and only their output is rounded to bf16. The fp32
DIN and GIN paths are unaffected.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate a requested device.

    Args:
        device: ``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"``.

    Returns:
        The :class:`torch.device`.

    Raises:
        RuntimeError: ``cuda`` was asked for and no CUDA device exists.
        ValueError: any other device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu")
    return dev
