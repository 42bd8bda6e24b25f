"""Optimizers and the RW-SGD payload (the port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    OptState,
    adamw,
    constant_schedule,
    cosine_schedule,
    sgd,
)
from repro_torch.optim.rw_sgd import (
    ReplicaSet,
    RwSgdOutputs,
    RwSgdPayload,
    fork_replica,
    init_replicas,
    local_sgd_step,
    replica_train_step,
)

__all__ = [
    "OptState",
    "Optimizer",
    "ReplicaSet",
    "RwSgdOutputs",
    "RwSgdPayload",
    "adamw",
    "constant_schedule",
    "cosine_schedule",
    "fork_replica",
    "init_replicas",
    "local_sgd_step",
    "replica_train_step",
    "sgd",
]
