"""Implementation resolution for the port's round and estimator paths.

The same layering as the JAX package's ``kernels/platform.py``: an
explicit config value wins; ``"auto"`` resolves through the ``best_*``
helpers, which honour the ``REPRO_ESTIMATOR_IMPL`` / ``REPRO_ROUND_IMPL``
environment variables (validated) before the default. The defaults are
the TPU column of the reference, since the card runs the kernels:
``estimator_impl="auto"`` -> ``"fused"``, ``round_impl="auto"`` ->
``"fused"``, and the fused round is the hand-written ``whole_round``
kernel (on CPU tensors its plain version).
"""
from __future__ import annotations

import os

ESTIMATOR_IMPLS = ("gather", "compare", "pallas", "fused")
ROUND_IMPLS = ("fused", "unfused")
# the estimator family the whole_round kernel's node-sum theta computes
NODE_SUM_FAMILY = ("compare", "pallas", "fused")


def _env_impl(var: str, allowed: tuple) -> str | None:
    val = os.environ.get(var)
    if val is None or val == "":
        return None
    if val not in allowed:
        raise ValueError(
            f"{var}={val!r} is not a valid override; expected one of {allowed}"
        )
    return val


def best_estimator_impl() -> str:
    """``estimator_impl="auto"``: the env override, else ``"fused"``."""
    return _env_impl("REPRO_ESTIMATOR_IMPL", ESTIMATOR_IMPLS) or "fused"


def best_round_impl() -> str:
    """``round_impl="auto"``: the env override, else ``"fused"``."""
    return _env_impl("REPRO_ROUND_IMPL", ROUND_IMPLS) or "fused"


# how round_impl="fused" executes: the whole_round kernel (the
# reference's "pallas" backend; its cumulative-carry "ref" backend is not
# ported)
FUSED_ROUND_BACKEND = "kernel"
