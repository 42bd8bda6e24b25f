from repro_torch.checkpoint.checkpoint import (
    CheckpointMismatchError,
    load_pytree,
    save_pytree,
    save_walk_snapshot,
)

__all__ = [
    "CheckpointMismatchError",
    "save_pytree",
    "load_pytree",
    "save_walk_snapshot",
]
