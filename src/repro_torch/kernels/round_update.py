"""The round kernels on the card: ``round_update`` and ``whole_round``.

``round_update`` is one observation round (``estimator_impl="fused"`` of
the unfused round): the return-time histogram scatter-add at
``clip(r, 1, B) - 1`` for valid walks, the ``last_seen`` scatter-max,
and the node sums of every row. It replaces
``src/repro/kernels/round_update.py::round_update_pallas``
(``csrc/round_update.cu``).

``whole_round`` is one whole round (``round_impl="fused"``, the port's
default): topology step, resident kills, the masked rank-select hop,
walk failures, observation, per-walk theta, the pairwise choose and the
fork / terminate masks. It replaces ``whole_round_pallas``
(``csrc/whole_round.cu``): two launches on the current stream, a
node-tiled topology pass and one CTA per trajectory for the rest, whose
shared memory does not grow with n, so any graph size runs. Every
uniform is drawn by the caller and enters as data; fork and terminate
execution stays outside, as in the reference.

Both update ``last_seen`` / ``hist`` / ``total`` in place (a round
touches W rows of an n-row table) and return them. Each has a plain
PyTorch version here, run for CPU tensors and held bitwise against the
kernel on the card; for CUDA tensors the wrapper launches the kernel or
raises. Counts are exact integers and the only float work is the
node-sum's one division (``csrc/survival.cuh``), so all outputs are
bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.core import estimator as est
from repro_torch.core import failures as flr
from repro_torch.core import protocol as prt
from repro_torch.core import walkers as wlk
from repro_torch.graphs.state import availability_rows
from repro_torch.kernels import _build
from repro_torch.kernels._launch import I, P, arg, check_aligned, count_launch, on_cpu, stream

NEVER = est.NEVER


# ---------------------------------------------------------------------------
# round_update
# ---------------------------------------------------------------------------


def round_update_plain(last_seen, hist, total, pos, track, r, valid, upd, t):
    """``record_returns`` -> ``last_seen`` scatter-max -> node sums, the
    reference's unfused sequence (``round_update_ref``)."""
    rts = est.record_returns(est.ReturnTimeState(hist, total), pos, r, valid)
    est.scatter_max_last_seen(last_seen, pos, track, upd)
    sums = est.node_sums_compare(last_seen, rts.hist, rts.total, t)
    return last_seen, rts.hist, rts.total, sums


def round_update(last_seen, hist, total, pos, track, r, valid, upd, t):
    """One observation round; returns ``(last_seen, hist, total, sums)``.
    Shapes: last_seen (batch, n, C) int32, hist (batch, n, B) int16,
    total (batch, n) int32; pos / track / r / upd (batch, W) int32,
    valid (batch, W) bool; t (batch,) int32."""
    batch, n, C = last_seen.shape
    B = hist.shape[2]
    W = pos.shape[1]
    walk = (batch, W)
    ptrs = (
        arg(last_seen, "last_seen", torch.int32, (batch, n, C)),
        arg(hist, "hist", torch.int16, (batch, n, B)),
        arg(total, "total", torch.int32, (batch, n)),
        arg(pos, "pos", torch.int32, walk),
        arg(track, "track", torch.int32, walk),
        arg(r, "r", torch.int32, walk),
        arg(valid, "valid", torch.bool, walk),
        arg(upd, "upd", torch.int32, walk),
        arg(t, "t", torch.int32, (batch,)),
    )
    if on_cpu(last_seen, hist, total, pos, track, r, valid, upd, t):
        return round_update_plain(last_seen, hist, total, pos, track, r, valid, upd, t)
    check_aligned(hist, "hist")
    sums = torch.empty((batch, n), dtype=torch.float32, device=last_seen.device)
    fn = _build.load("round_update").round_update_launch
    fn.argtypes = [P] * 10 + [I] * 5 + [P]
    fn.restype = I
    status = fn(*ptrs, sums.data_ptr(), batch, n, C, B, W, stream())
    _build.check(status, "round_update")
    count_launch(round_update)
    return last_seen, hist, total, sums


round_update.launches = 0
round_update.symbols = ("round_update_kernel",)  # its kernel's device function


# ---------------------------------------------------------------------------
# whole_round
# ---------------------------------------------------------------------------

# params_f columns: p_fail, p_node_fail, p_link_fail, p_node_recover,
# p_link_recover, eps, eps2, fork probability (start gates folded in:
# a rate of -1 never fires); params_i columns: t, byz_kill_node,
# pacman_node, enabled (a node of -1 never matches)
PARAMS_F = 8
PARAMS_I = 4


def whole_round_plain(
    last_seen, hist, total, node_up, edge_up, pos, track, active,
    neighbors, degrees, u_move, u_pfail, u_fork, u_term, u_burst,
    burst_sizes_eff, u_nfail, u_nrec, sched_down, e_fail, e_rec,
    params_f, params_i, decafork_plus,
):
    """The round's stage sequence on pre-drawn uniforms, literally."""
    (p_fail, p_nfail, p_lfail, p_nrec, p_lrec, eps, eps2, p_fork) = (
        params_f[:, i] for i in range(PARAMS_F)
    )
    t, byz_node, pac_node, enabled = (params_i[:, i] for i in range(PARAMS_I))

    def col(x):
        return x.view(-1, 1)

    # topology
    fail = e_fail < p_lfail.view(-1, 1, 1)
    rec = e_rec < p_lrec.view(-1, 1, 1)
    edge_new = torch.where(edge_up, ~fail, rec)
    crash = u_nfail < col(p_nfail)
    recov = u_nrec < col(p_nrec)
    node_new = torch.where(node_up, ~(crash | sched_down), recov & ~sched_down)
    # resident kills and the masked rank-select hop
    act = active & torch.gather(node_new, 1, pos.long())
    p = pos.long()
    nbr = neighbors[p]  # (batch, W, D)
    batch, W, D = nbr.shape
    nbr_up = torch.gather(node_new, 1, nbr.reshape(batch, -1).long()).view(batch, W, D)
    avail = availability_rows(
        est.gather_rows(edge_new, pos), torch.gather(node_new, 1, p), nbr_up, degrees[p]
    )
    new_pos = wlk.move_walks_rows(wlk.WalkState(pos, act, track), nbr, u_move, avail)
    # walk-level failures
    act = act & ~(u_pfail < col(p_fail))
    act = flr.burst_kills(act, u_burst, burst_sizes_eff)
    act = act & ~(new_pos == col(byz_node)) & ~(new_pos == col(pac_node))
    # observation
    prev = est.gather_rows(last_seen, new_pos).gather(2, track.long()[..., None])[..., 0]
    r = col(t) - prev
    valid = act & (prev != NEVER) & (r >= 1)
    upd = torch.where(act, col(t), NEVER)
    est.record_returns(est.ReturnTimeState(hist, total), new_pos, r, valid)
    est.scatter_max_last_seen(last_seen, new_pos, track, upd)
    # theta at the walks' rows, decisions
    sums = est.survival_node_sums_rows(
        est.gather_rows(last_seen, new_pos), est.gather_rows(hist, new_pos),
        torch.gather(total, 1, new_pos.long()), t,
    )
    theta = sums - 0.5
    chosen = prt.choose_walks_pairwise(new_pos, act)
    fork, term = prt.decisions_from_uniforms(
        theta, chosen, u_fork, u_term, col(eps), col(eps2), col(p_fork), col(enabled) > 0,
        decafork_plus,
    )
    return (last_seen, hist, total, node_new, edge_new, new_pos, act, theta,
            chosen, fork, term)


def whole_round(
    last_seen, hist, total, node_up, edge_up, pos, track, active,
    neighbors, degrees, u_move, u_pfail, u_fork, u_term, u_burst,
    burst_sizes_eff, u_nfail, u_nrec, sched_down, e_fail, e_rec,
    params_f, params_i, *, decafork_plus: bool,
):
    """One whole round for every trajectory. Returns ``(last_seen, hist,
    total, node_up, edge_up, pos, active, theta, chosen, fork, term)``.

    Shapes: last_seen (batch, n, C) int32, hist (batch, n, B) int16,
    total (batch, n) int32, node_up (batch, n) bool, edge_up
    (batch, n, D) bool; pos / track (batch, W) int32, active (batch, W)
    bool; neighbors (n, D) / degrees (n,) int32; u_move / u_pfail /
    u_fork / u_term (batch, W) f32; u_burst (batch, K, W) f32;
    burst_sizes_eff (batch, K) int32; u_nfail / u_nrec (batch, n) f32;
    sched_down (batch, n) bool; e_fail / e_rec (batch, n, D) f32
    (mirror-symmetrized); params_f (batch, 8) f32; params_i (batch, 4)
    int32."""
    args = (
        last_seen, hist, total, node_up, edge_up, pos, track, active,
        neighbors, degrees, u_move, u_pfail, u_fork, u_term, u_burst,
        burst_sizes_eff, u_nfail, u_nrec, sched_down, e_fail, e_rec,
        params_f, params_i,
    )
    batch, n, C = last_seen.shape
    B = hist.shape[2]
    D = edge_up.shape[2]
    W = pos.shape[1]
    K = u_burst.shape[1]
    walk = (batch, W)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    expect = (
        ("last_seen", i32, (batch, n, C)), ("hist", torch.int16, (batch, n, B)),
        ("total", i32, (batch, n)), ("node_up", b8, (batch, n)),
        ("edge_up", b8, (batch, n, D)), ("pos", i32, walk), ("track", i32, walk),
        ("active", b8, walk), ("neighbors", i32, (n, D)), ("degrees", i32, (n,)),
        ("u_move", f32, walk), ("u_pfail", f32, walk), ("u_fork", f32, walk),
        ("u_term", f32, walk), ("u_burst", f32, (batch, K, W)),
        ("burst_sizes_eff", i32, (batch, K)), ("u_nfail", f32, (batch, n)),
        ("u_nrec", f32, (batch, n)), ("sched_down", b8, (batch, n)),
        ("e_fail", f32, (batch, n, D)), ("e_rec", f32, (batch, n, D)),
        ("params_f", f32, (batch, PARAMS_F)), ("params_i", i32, (batch, PARAMS_I)),
    )
    ptrs = tuple(arg(a, *e) for a, e in zip(args, expect))
    if on_cpu(*args):
        return whole_round_plain(*args, decafork_plus)
    check_aligned(hist, "hist")
    dev = last_seen.device
    outs = (
        torch.empty((batch, n), dtype=b8, device=dev),
        torch.empty((batch, n, D), dtype=b8, device=dev),
        torch.empty(walk, dtype=i32, device=dev),
        torch.empty(walk, dtype=b8, device=dev),
        torch.empty(walk, dtype=f32, device=dev),
        torch.empty(walk, dtype=b8, device=dev),
        torch.empty(walk, dtype=b8, device=dev),
        torch.empty(walk, dtype=b8, device=dev),
    )
    fn = _build.load("whole_round").whole_round_launch
    fn.argtypes = [P] * 31 + [I] * 8 + [P]
    fn.restype = I
    status = fn(
        *ptrs, *(o.data_ptr() for o in outs),
        batch, n, C, B, D, W, K, int(decafork_plus), stream(),
    )
    _build.check(status, "whole_round")
    count_launch(whole_round)
    return (last_seen, hist, total) + outs


whole_round.launches = 0
# its kernel's device function: a call is one launch, counted at the
# per-trajectory kernel (each call's topology launch goes with it)
whole_round.symbols = ("whole_round_kernel",)
