"""Measurement scripts for the port: the ``profile_*`` scripts (each needs
a CUDA device), the paper's figures (one module a figure or table) and
the serving benchmarks of Quiver's mechanisms (one module each, each
asserting its invariant in the run), run by :mod:`repro_torch.bench.run`
over the harness in :mod:`repro_torch.bench.common` (on the card unless
``--device cpu``)."""
