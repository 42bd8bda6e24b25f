"""Synthetic data for the port: random batches and the RW-SGD payload's
node-sharded Markov task."""
from repro_torch.data.synthetic import (
    SyntheticTask,
    make_markov_task,
    node_batches,
    random_batch_like,
    sample_batch,
)

__all__ = ["SyntheticTask", "make_markov_task", "node_batches", "random_batch_like",
           "sample_batch"]
