"""The comparison that decides ``correct``: the program's outputs and
final state on the compared rows against the reference's.

Three numbers, each with its limit in the traffic file:

- ``outputs_mismatched``: entries of the integer outputs (``z``,
  ``forks``, ``terms``, ``failures``, and where recorded ``fork_parent``
  and ``terminated``) over every round that differ;
- ``state_mismatched``: entries of the final state (the walks' slots,
  positions, ids and liveness, ``last_seen``, the return-time
  histograms and counts, the live node and link masks, the step and the
  key) that differ;
- ``theta_mean_gap``: the largest absolute gap of the per-round mean
  theta-hat of the chosen walks (float32 in the program, float64 in the
  reference), over every round.
"""
from __future__ import annotations

import numpy as np

INT_OUTPUTS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
STATE = ("t", "pos", "active", "track", "last_seen", "hist", "total", "key", "node_up",
         "edge_up")


def _mismatched(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int((a.astype(np.int64) != b.astype(np.int64)).sum())


def compare(got: list, want: list) -> dict:
    """``got``: per compared chunk ``(outputs, state)`` of the program;
    ``want``: the reference's ``(outputs, final)`` of the same rows."""
    outs = state = 0
    gap = 0.0
    for (g_out, g_state), (w_out, w_state) in zip(got, want):
        for f in INT_OUTPUTS:
            if f in g_out:
                outs += _mismatched(g_out[f], w_out[f])
        for f in STATE:
            state += _mismatched(g_state[f], w_state[f])
        d = np.abs(np.asarray(g_out["theta_mean"], np.float64) - w_out["theta_mean"])
        gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0)
    return dict(outputs_mismatched=outs, state_mismatched=state, theta_mean_gap=gap)

