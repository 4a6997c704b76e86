"""Measurement scripts for the port: the ``profile_*`` scripts (each needs
a CUDA device), and the paper's figures, one module a figure or table,
run by :mod:`repro_torch.bench.run` over the harness in
:mod:`repro_torch.bench.common` (on the card unless ``--device cpu``)."""
