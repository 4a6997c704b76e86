"""Deterministic test infrastructure (fake clocks — no sleeps in tests).

Runtime components default to ``time.monotonic`` and accept any zero-arg
float callable, so this package stays test-only at runtime.
"""
from repro_torch.testing.clock import FakeClock

__all__ = ["FakeClock"]
