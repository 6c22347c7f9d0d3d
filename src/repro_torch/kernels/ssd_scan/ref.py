"""Oracle for the SSD chunk kernel: the sequential recurrence and the
plain blocked algorithm.

Re-exports the model-level reference so kernel tests and model tests
share a single source of truth.
"""

from repro_torch.models.mamba2 import ssd_chunked, ssd_naive

__all__ = ["ssd_naive", "ssd_chunked"]
