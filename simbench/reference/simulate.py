"""The plain reference of the self-regulating random walks (DecAFork,
DecAFork+, MissingPerson), written from the paper's protocol and the JAX
package's semantics, in numpy, one trajectory per row.

It imports nothing of the system under test. Its inputs are the graph's
adjacency, each row's numeric parameters and each row's threefry key; it
returns every round's outputs and the final state, which the benchmark
holds the program's to.

One synchronous round t -> t + 1, in order:

1. the topology: each up node crashes w.p. ``p_node_fail`` (from
   ``node_fail_start``), each down node recovers w.p.
   ``p_node_recover``; each link fails / recovers likewise, one draw per
   undirected edge (at its lower endpoint); a crashed node takes its
   resident walks down;
2. every walk hops to a uniform available neighbour (an incident edge
   that is up, with both ends up), or holds where it has none;
3. walk failures: probabilistic (``p_fail``), then each burst's
   ``size`` lowest-scored active walks at its time;
4. observation: each walk's node records the walk's return time
   ``t - last_seen`` (when seen before and at least 1) in its
   histogram and sets ``last_seen`` to t;
5. each node chooses its lowest-slot active visitor; DecAFork's chosen
   walk computes theta-hat (Eq. 1: 1/2 plus, over the other walk ids the
   node has seen, the empirical survival of their elapsed times) and
   forks w.p. p below eps; DecAFork+ also terminates w.p. p above eps2;
   MissingPerson's chosen walk replaces each initial id unseen there for
   more than ``eps_mp`` rounds w.p. p;
6. terminations, then forks into the lowest free slots in event order
   (a DecAFork fork is a fresh id; a MissingPerson fork carries the
   missing id).

Draws (the JAX streams): the state key of a row folds the stream tag
(0 move, 1 probabilistic failure, 2 burst, 3 Byzantine, 4 decision, 5
topology) and then t. Only the words that decide something are drawn:
each word of the partitionable layout hashes its own counter, so a word
not drawn changes no other. A rate of 0 draws nothing.

``precision="bfloat16"`` rounds the round's float32 arithmetic to
bfloat16: every uniform as drawn, and theta-hat's division and
subtractions. It is the benchmark's control, which its comparison has to
refuse.
"""
from __future__ import annotations

import numpy as np

from simbench.reference import threefry as tf

NEVER = -1
ALGORITHMS = ("decafork", "decafork+", "missingperson")
# the tags of the round's streams
MOVE, PFAIL, BURST, BYZ, DECIDE, TOPO = range(6)


def _bf16(x):
    """Round float32 values to bfloat16 (nearest, ties to even), kept as
    float32."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class Topology:
    """The live node and link masks of every row, with their draws, on a
    torch device (node- and edge-sized work)."""

    def __init__(self, neighbors, mirror, rows, device, precision):
        import torch

        self.torch, self.device = torch, device
        R = rows["p_node_fail"].shape[0]
        n, D = neighbors.shape
        self.n, self.D = n, D
        self.nbr = torch.as_tensor(neighbors, dtype=torch.int64, device=device)
        self.mir = torch.as_tensor(mirror, dtype=torch.int64, device=device)
        self.lower = torch.arange(n, device=device)[:, None] < self.nbr
        self.node_up = torch.ones((R, n), dtype=torch.bool, device=device)
        self.edge_up = torch.ones((R, n, D), dtype=torch.bool, device=device)
        self.rows = rows
        self.uniform = ((lambda k, shape: tf.uniform_torch(k, shape, device)) if precision == "float32"
                        else (lambda k, shape: tf.uniform_torch(k, shape, device)
                              .to(torch.bfloat16).to(torch.float32)))

    def step(self, t: int, k_topo: np.ndarray):
        torch, rows = self.torch, self.rows
        n, D = self.n, self.D
        f32 = np.float32
        for r in range(k_topo.shape[0]):
            sub = tf.split(k_topo[r], 4)
            u_nf = self.uniform(sub[0], (n,))
            u_nr = self.uniform(sub[1], (n,))
            u_ef = self.uniform(sub[2], (n, D))
            u_er = self.uniform(sub[3], (n, D))
            e_f = torch.where(self.lower, u_ef, u_ef[self.nbr, self.mir])
            e_r = torch.where(self.lower, u_er, u_er[self.nbr, self.mir])
            p_nf = f32(rows["p_node_fail"][r]) if t >= rows["node_fail_start"][r] else f32(-1)
            p_lf = f32(rows["p_link_fail"][r]) if t >= rows["link_fail_start"][r] else f32(-1)
            crash = u_nf < float(p_nf)
            rec = u_nr < float(f32(rows["p_node_recover"][r]))
            self.node_up[r] = torch.where(self.node_up[r], ~crash, rec)
            fail = e_f < float(p_lf)
            lrec = e_r < float(f32(rows["p_link_recover"][r]))
            self.edge_up[r] = torch.where(self.edge_up[r], ~fail, lrec)

    def walk_view(self, pos: np.ndarray):
        """(node_up at pos, edge_up rows at pos, node_up of the neighbours
        at pos) as numpy, (R, W), (R, W, D), (R, W, D)."""
        torch = self.torch
        p = torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        up = torch.gather(self.node_up, 1, p)
        edges = torch.gather(self.edge_up, 1, p[..., None].expand(-1, -1, self.D))
        nb = self.nbr[p]  # (R, W, D)
        nb_up = torch.gather(self.node_up, 1, nb.reshape(nb.shape[0], -1)).reshape(nb.shape)
        return up.cpu().numpy(), edges.cpu().numpy(), nb_up.cpu().numpy()


def _theta(ls_rows, hist_rows, tot, t, precision):
    """theta-hat of walks from their node's rows: 1/2 + sum over the
    seen ids of S(t - last_seen), S(r) = 1 - #samples below r / total,
    minus the walk's own fresh id (S = 1, so -1 of the sum plus its 1/2:
    the node sum less 1/2). Integer work is exact; the float work is one
    division and two subtractions in ``precision``."""
    valid = ls_rows != NEVER
    r = np.where(valid, t - ls_rows, 0)
    B = hist_rows.shape[-1]
    cum = np.zeros(hist_rows.shape[:-1] + (B + 1,), dtype=np.int64)
    np.cumsum(hist_rows, axis=-1, dtype=np.int64, out=cum[..., 1:])
    below = np.take_along_axis(cum, np.minimum(r, B).astype(np.int64), axis=-1)
    mass = np.where(valid, below, 0).sum(-1)
    n_valid = valid.sum(-1)
    f32 = np.float32
    if precision == "bfloat16":
        q = _bf16(_bf16(mass.astype(f32)) / _bf16(np.maximum(tot, 1).astype(f32)))
        sums = np.where(tot > 0, _bf16(_bf16(n_valid.astype(f32)) - q), _bf16(n_valid.astype(f32)))
        return _bf16(sums - f32(0.5))
    q = mass.astype(f32) / np.maximum(tot, 1).astype(f32)
    sums = np.where(tot > 0, n_valid.astype(f32) - q, n_valid.astype(f32))
    return (sums - f32(0.5)).astype(f32)


def _allocate(active, ev):
    """Pair the r-th event of each row (flat order) with its r-th free
    slot while slots last: ``(ok (R, E), slot (R, E))``."""
    R, W = active.shape
    free = ~active
    n_free = free.sum(1, keepdims=True)
    ev_rank = np.cumsum(ev, axis=1) - 1
    ok = ev & (ev_rank < n_free)
    free_slots = np.argsort(~free, axis=1, kind="stable")  # free slots first, ascending
    slot = np.take_along_axis(free_slots, np.clip(ev_rank, 0, W - 1), axis=1)
    return ok, slot


def init_state(keys, n, W, B, z0, algorithm):
    """The state at t = 0 of one trajectory per key row."""
    R = keys.shape[0]
    sub = tf.split(keys, 2)
    pos = tf.randint(sub[:, 0], (W,), n)
    slots = np.arange(W, dtype=np.int32)
    active = slots[None, :] < z0[:, None]
    track = np.broadcast_to(slots, (R, W)).astype(np.int32).copy()
    if algorithm == "missingperson":
        col = np.where(slots[None, :] < z0[:, None], 0, NEVER).astype(np.int32)
        last_seen = np.broadcast_to(col[:, None, :], (R, n, W)).copy()
    else:
        last_seen = np.full((R, n, W), NEVER, dtype=np.int32)
        rr, ww = np.nonzero(active)
        last_seen[rr, pos[rr, ww], track[rr, ww]] = 0
    return dict(
        t=0, pos=pos, active=active, track=track, last_seen=last_seen,
        hist=np.zeros((R, n, B), dtype=np.int16), total=np.zeros((R, n), dtype=np.int32),
        key=sub[:, 1].copy(),
    )


def simulate(graph: dict, algorithm: str, W: int, B: int, rows: dict, keys: np.ndarray,
             steps: int, *, topo_device="cpu", precision="float32"):
    """``steps`` rounds of one trajectory per row of ``keys`` ((R, 2)
    uint32). ``graph``: ``neighbors`` (n, D), ``degrees`` (n,),
    ``mirror`` (n, D). ``rows``: per-row arrays of ``z0``, ``eps``,
    ``eps2``, ``p``, ``eps_mp``, ``protocol_start``, ``burst_times`` /
    ``burst_sizes`` (R, K), ``p_fail``, ``p_fail_start`` and the
    topology rates. Returns ``(outputs, final)``: outputs ``z``,
    ``forks``, ``terms``, ``failures`` (R, steps) int32, ``theta_mean``
    (R, steps) float64, ``fork_parent`` (R, steps, W) int32,
    ``terminated`` (R, steps, W) bool; the final state as numpy arrays."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"the reference runs {ALGORITHMS}, not {algorithm!r}")
    nbr = np.asarray(graph["neighbors"], dtype=np.int64)
    deg = np.asarray(graph["degrees"], dtype=np.int64)
    n, D = nbr.shape
    keys = np.asarray(keys, dtype=np.uint32)
    R = keys.shape[0]
    f32 = np.float32
    z0 = np.asarray(rows["z0"], dtype=np.int64)
    eps = np.asarray(rows["eps"], dtype=f32)[:, None]
    eps2 = np.asarray(rows["eps2"], dtype=f32)[:, None]
    p = np.asarray(rows["p"], dtype=f32)[:, None]
    eps_mp = np.asarray(rows["eps_mp"], dtype=f32)[:, None, None]
    start = np.asarray(rows["protocol_start"], dtype=np.int64)
    bt = np.asarray(rows["burst_times"], dtype=np.int64).reshape(R, -1)
    bs = np.asarray(rows["burst_sizes"], dtype=np.int64).reshape(R, -1)
    p_fail = np.asarray(rows["p_fail"], dtype=f32)[:, None]
    p_fail_start = np.asarray(rows["p_fail_start"], dtype=np.int64)
    churn = bool(np.any(np.asarray(rows["p_node_fail"]) > 0)
                 or np.any(np.asarray(rows["p_link_fail"]) > 0))
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    topo = (Topology(graph["neighbors"], graph["mirror"], rows, topo_device, precision)
            if churn else None)

    def uni(words):
        u = tf.to_uniform(words)
        return u if precision == "float32" else _bf16(u)

    s = init_state(keys, n, W, B, z0, algorithm)
    pos, active, track = s["pos"], s["active"], s["track"]
    last_seen, hist, total = s["last_seen"], s["hist"], s["total"]
    tag_keys = tf.fold_in(s["key"][None], np.arange(6)[:, None])  # (6, R, 2)
    slots = np.arange(W)
    ridx = np.arange(R)[:, None]
    within = np.arange(D)[None, :] < deg[:, None]  # (n, D)

    out = dict(
        z=np.zeros((R, steps), np.int32), forks=np.zeros((R, steps), np.int32),
        terms=np.zeros((R, steps), np.int32), failures=np.zeros((R, steps), np.int32),
        theta_mean=np.zeros((R, steps), np.float64),
        fork_parent=np.full((R, steps, W), -1, np.int32),
        terminated=np.zeros((R, steps, W), bool),
    )
    # every round's stream keys, and the hop and decision words of every
    # round at once: they depend on the keys alone
    k_all = tf.fold_in(tag_keys[:, :, None, :], np.arange(steps)[None, None, :])  # (6, R, T, 2)
    u_move = uni(tf.bits(k_all[MOVE], (W,)))  # (R, T, W)
    if algorithm != "missingperson":
        dec_all = tf.split(k_all[DECIDE], 2)  # (R, T, 2, 2)
        u_fork_all = uni(tf.bits(dec_all[:, :, 0], (W,)))
        u_term_all = (uni(tf.bits(dec_all[:, :, 1], (W,)))
                      if algorithm == "decafork+" else None)
    for t in range(steps):
        k = k_all[:, :, t]  # (6, R, 2)
        n_before = active.sum(1)
        # 1. topology, and the walks a crash takes down
        if topo is not None:
            topo.step(t, k[TOPO])
            up_at, edge_rows, nb_up = topo.walk_view(pos)
            active = active & up_at
            avail = within[pos] & edge_rows & up_at[..., None] & nb_up
        else:
            avail = within[pos]
        # 2. the hop
        adeg = avail.sum(-1)
        idx = np.minimum((u_move[:, t] * adeg.astype(f32)).astype(np.int32), adeg - 1)
        rank = np.cumsum(avail, axis=-1) - 1
        sel = np.argmax((rank == idx[..., None]) & avail, axis=-1)
        nxt = np.take_along_axis(nbr[pos], sel[..., None], axis=-1)[..., 0]
        pos = np.where(active & (adeg > 0), nxt, pos).astype(np.int32)
        # 3. walk failures
        if np.any(p_fail > 0):
            u = uni(tf.bits(k[PFAIL], (W,)))
            active = active & ~((u < p_fail) & (t >= p_fail_start)[:, None])
        for b in range(bt.shape[1]):
            size = np.where(bt[:, b] == t, bs[:, b], 0)
            if not size.any():
                continue
            u = uni(tf.bits(tf.fold_in(k[BURST], b), (W,)))
            score = np.where(active, u, np.inf)
            below = (score[:, :, None] > score[:, None, :]).sum(-1)
            active = active & ~(below < size[:, None])
        failures = n_before - active.sum(1)
        # 4. observation
        prev = last_seen[ridx, pos, track]
        r = t - prev
        valid = active & (prev != NEVER) & (r >= 1)
        rr, ww = np.nonzero(valid)
        np.add.at(hist, (rr, pos[rr, ww], np.clip(r[rr, ww], 1, B) - 1), 1)
        np.add.at(total, (rr, pos[rr, ww]), 1)
        rr, ww = np.nonzero(active)
        np.maximum.at(last_seen, (rr, pos[rr, ww], track[rr, ww]), t)
        # 5. each node's chosen walk decides
        best = np.full((R, n), W, dtype=np.int64)
        np.minimum.at(best, (rr, pos[rr, ww]), ww)
        chosen = active & (best[ridx, pos] == slots)
        enabled = (t >= start)[:, None]
        term = np.zeros((R, W), bool)
        theta_mean = np.zeros(R)
        if algorithm == "missingperson":
            ev = _missingperson_events(k[DECIDE], last_seen, pos, track, chosen, t, z0,
                                       eps_mp, p, enabled, uni)
            ok, slot = _allocate(active, ev.reshape(R, -1))
            er, ee = np.nonzero(ok)
            parent, ident = ee // W, ee % W
            s_ = slot[er, ee]
            fork_parent = np.full((R, W), -1, np.int32)
            fork_parent[er, s_] = parent
            origin = pos[er, parent]
            active = active.copy()
            active[er, s_] = True
            pos = pos.copy()
            pos[er, s_] = origin
            track = track.copy()
            track[er, s_] = ident
            n_forks = ok.sum(1)
        else:
            cr, cw = np.nonzero(chosen)
            cp = pos[cr, cw]
            theta = _theta(last_seen[cr, cp], hist[cr, cp], total[cr, cp], t, precision)
            u_fork = u_fork_all[cr, t, cw]
            fork = np.zeros((R, W), bool)
            fork[cr, cw] = (theta < eps[cr, 0]) & (u_fork < p[cr, 0]) & enabled[cr, 0]
            if algorithm == "decafork+":
                u_term = u_term_all[cr, t, cw]
                term[cr, cw] = ((theta > eps2[cr, 0]) & (u_term < p[cr, 0]) & enabled[cr, 0]
                                & ~fork[cr, cw])
            np.add.at(theta_mean, cr, theta.astype(np.float64))
            theta_mean /= np.maximum(chosen.sum(1), 1)
            active = active & ~term
            ok, slot = _allocate(active, fork)
            er, ee = np.nonzero(ok)
            s_ = slot[er, ee]
            fork_parent = np.full((R, W), -1, np.int32)
            fork_parent[er, s_] = ee
            origin = pos[er, ee]
            active = active.copy()
            active[er, s_] = True
            pos = pos.copy()
            pos[er, s_] = origin
            track = track.copy()
            track[er, s_] = s_
            last_seen[er, :, s_] = NEVER
            last_seen[er, origin, s_] = t
            n_forks = ok.sum(1)
        out["z"][:, t] = active.sum(1)
        out["forks"][:, t] = n_forks
        out["terms"][:, t] = term.sum(1)
        out["failures"][:, t] = failures
        out["theta_mean"][:, t] = theta_mean
        out["fork_parent"][:, t] = fork_parent
        out["terminated"][:, t] = term
    final = dict(t=np.full(R, steps, np.int32), pos=pos, active=active, track=track,
                 last_seen=last_seen, hist=hist, total=total, key=s["key"])
    if topo is not None:
        final["node_up"] = topo.node_up.cpu().numpy()
        final["edge_up"] = topo.edge_up.cpu().numpy()
    else:
        final["node_up"] = np.ones((R, n), bool)
        final["edge_up"] = np.ones((R, n, D), bool)
    return out, final


def _missingperson_events(k_dec, last_seen, pos, track, chosen, t, z0, eps_mp, p, enabled, uni):
    """(R, W, C): walk k's node deems initial id l missing (unseen there
    for more than eps_mp rounds) and forks a copy of k carrying l, w.p. p
    (the (W, C) uniforms of the decision key, drawn where it can fire)."""
    R, W = pos.shape
    C = last_seen.shape[2]
    ridx = np.arange(R)[:, None]
    ls = last_seen[ridx, pos]  # (R, W, C)
    ids = np.arange(C)
    cand = (chosen[..., None] & ((t - ls).astype(np.float32) > eps_mp)
            & (ids < z0[:, None, None]) & (ids != track[..., None]) & enabled[..., None])
    er, ek, el = np.nonzero(cand)
    u = uni(tf.bits_at(k_dec[er], ek * C + el))
    ev = np.zeros((R, W, C), bool)
    ev[er, ek, el] = u < p[er, 0]
    return ev
