"""PyTorch/CUDA port of the Quiver serving system for one NVIDIA H100.

The package mirrors ``src/repro`` module for module (``graph``, ``core``,
``kernels``, ``models``, ``serving``, ``launch``) and imports only
``torch``, numpy and the standard library: nothing of JAX and nothing of
the ``repro`` reference package, so it runs where JAX is absent. The two
Pallas kernels of the serving path (``tiered_gather``, ``gather_aggregate``)
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
the CPU and of the JAX reference.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
