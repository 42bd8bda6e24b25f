"""Synthetic data for the port (``random_batch_like``)."""
from repro_torch.data.synthetic import random_batch_like

__all__ = ["random_batch_like"]
