"""The walk-payload API (the port of ``repro.core.payload``): the
computational task the walks carry.

A :class:`Payload` owns a *carry* (a tree of tensors) that rides the
simulator's round loop beside ``SimState``, with three hooks called once
per synchronous round, in the protocol's own slot order (terminations
free slots before forks reallocate them, so a terminated and re-forked
slot must be cleared before the fresh copy lands):

  ``on_terminate(carry, terminated)``
      Slots deliberately terminated this round, a (batch, W) bool mask.
      The default keeps their state: a later re-fork overwrites the slot
      wholesale (``optim.rw_sgd.fork_replica``).
  ``on_fork(carry, fork_parent)``
      Walk ``fork_parent[b, s]`` (>= 0) was duplicated into slot ``s`` of
      trajectory ``b`` this round; copy slot state parent -> child. The
      map is the one ``walkers.execute_forks`` emits.
  ``on_visit(carry, walks, t, key)``
      The per-round local step: ``walks.pos`` (batch, W) is the node each
      slot sits on *after* this round's hop, ``walks.active`` whether it
      is a live walk, ``t`` (batch,) the pre-round step counter and
      ``key`` (batch, 2) the round's payload key. Returns ``(carry,
      outputs)``; the per-round ``outputs`` (a NamedTuple of tensors with
      the leading batch axis, or ``()``) are stacked over rounds after
      the batch axis, as the step outputs are.

Every hook sees the port's leading trajectory axis (one row per
trajectory of an ensemble or sweep) where the reference vmaps one
trajectory's hooks. ``init(keys)`` builds the carry of every row from
``payload_init_key(keys)``; ``init`` and ``on_visit`` also take the
threefry layout (``partitionable``) the run draws with.

Payload keys fold dedicated stream tags (``PAYLOAD_INIT_TAG``,
``PAYLOAD_STREAM``) that the simulator never uses, so attaching any
payload, or none, leaves every simulator stream, and so every
``StepOutputs`` trajectory, bitwise unchanged.

Identity: by default a payload hashes by identity. One that implements
:meth:`Payload.signature` (a stable tuple of its static configuration)
compares and hashes structurally, so equal payloads share one slot of
the Plan's executable cache (``repro_torch.api.plan``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.utils import prng

# dedicated PRNG stream tags; the simulator uses fold_in_time tags 0..5
# (and 7 for a mobile Pac-Man)
PAYLOAD_INIT_TAG = 0x70AD  # folds the run key into the payload init key
PAYLOAD_STREAM = 6  # per-round on_visit key stream


class Payload:
    """Base payload: empty carry, every hook a no-op (itself a valid
    payload, which leaves the control plane as it is)."""

    def validate(self, pcfg) -> None:
        """Static compatibility check against a ProtocolConfig, made for
        every scenario a Plan runs; raise on a mismatch."""

    def signature(self) -> Tuple | None:
        """A hashable tuple of everything structural (model config,
        optimizer hyperparameters, task identity, capacities). Two
        payloads with equal signatures are the same program and share a
        cache slot; ``None`` keeps identity semantics."""
        return None

    def _signature_key(self) -> Tuple | None:
        """Type-qualified stable identity, or None for identity hashing."""
        sig = self.signature()
        if sig is None:
            return None
        return (type(self).__module__, type(self).__qualname__, sig)

    def __eq__(self, other):
        key = self._signature_key()
        if key is None or not isinstance(other, Payload):
            return self is other
        return key == other._signature_key()

    def __hash__(self):
        key = self._signature_key()
        return object.__hash__(self) if key is None else hash(key)

    def output_fields(self) -> Tuple[str, ...]:
        """Names of the per-round output fields ``on_visit`` returns, for
        the ``outputs=`` payload-field selection (``core.outputs``)."""
        return ()

    def init(self, keys: torch.Tensor, *, partitionable: bool = True) -> Any:
        """The initial carry of every row of ``keys`` (batch, 2)."""
        return ()

    def on_fork(self, carry: Any, fork_parent: torch.Tensor) -> Any:
        return carry

    def on_visit(self, carry: Any, walks, t: torch.Tensor, key: torch.Tensor, *,
                 partitionable: bool = True):
        return carry, ()

    def on_terminate(self, carry: Any, terminated: torch.Tensor) -> Any:
        return carry


def payload_init_key(keys: torch.Tensor) -> torch.Tensor:
    """The carry-init key derived from a trajectory's run key (any
    leading axes)."""
    return prng.fold_in(keys, PAYLOAD_INIT_TAG)
