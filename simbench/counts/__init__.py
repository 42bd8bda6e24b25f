"""The work of one protocol round, counted from a configuration's shapes,
whatever implements the round, and the peaks it is divided by.

Peaks of one NVIDIA H100 SXM (80 GB HBM3), at its 700 W limit:

- ``HBM_BYTES_PER_S`` 3.35e12: the data sheet's memory bandwidth;
- ``INT32_OPS_PER_S`` 1.6727e13: the CUDA cores' 32-bit integer rate,
  64 INT32 lanes per SM (the Hopper architecture whitepaper) x 132 SMs x
  1.98 GHz, the clock at which the data sheet's 67 TFLOP/s of float32
  (128 lanes, 2 FLOPs a fused multiply-add) holds.

A round's own work (``round_work``) is what the algorithm must do once:

- bytes: each trajectory's walk vectors read and written, the rows of
  last_seen, the histogram and the sample count that its walks' nodes
  hold (counted at Z0 walks, the count the protocol holds the walks to),
  one entry of each written per walk, the live topology masks read and
  written (every round updates them), and the round's outputs written;
- integer operations: the threefry-2x32 blocks of every 32-bit word the
  round draws (the reference semantics draw them whatever the rates) and
  of its keys. ``OPS_PER_BLOCK`` is the fewest 32-bit instructions of a
  block: 20 mix steps of an add, a funnel-shift rotate and a xor, 2 key
  adds, and 5 key injections of a two-input and a three-input add; a
  word of random bits adds the xor of the block's two words.

``whole_round_work`` counts what the whole_round kernel must move when
every uniform enters it as data: the masks and their four uniform
fields in and the masks out, the walk vectors and their uniforms, the
neighbour rows at the walks, and the rows its Z0 walks visit.

Each returns ``(bytes, int_ops)`` per round for ``batch`` trajectories;
``least_seconds`` turns such a pair into the least time the chip could
take.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
OPS_PER_BLOCK = 20 * 3 + 2 + 5 * 2
OPS_PER_WORD = OPS_PER_BLOCK + 1


def words_drawn(shape: dict, algorithm: str) -> tuple:
    """(key blocks, random words) one trajectory's round draws: the six
    streams' keys (two folds each), the hop and probabilistic-failure
    words, each burst's key and words, the Byzantine word, the decision
    (DecAFork: a split and the fork and terminate words; MissingPerson:
    a (W, W) grid), the topology's split and its node and edge words."""
    n, D, W, K = shape["n"], shape["degree"], shape["max_walks"], shape["bursts"]
    blocks = 6 * 2 + K + 4
    words = 2 * W + K * W + 1 + 2 * n + 2 * n * D
    if algorithm == "missingperson":
        words += W * W
    else:
        blocks += 2
        words += 2 * W
    return blocks, words


def round_work(shape: dict, algorithm: str, batch: int) -> tuple:
    n, D, W, B, z0 = shape["n"], shape["degree"], shape["max_walks"], shape["rt_bins"], shape["z0"]
    walks = 2 * W * (4 + 4 + 1)
    rows = z0 * (4 * W + 2 * B + 4) + W * (4 + 2 + 4)
    topology = 2 * (n + n * D)
    outputs = 5 * 4 + W * (4 + 1)
    blocks, words = words_drawn(shape, algorithm)
    nbytes = batch * (walks + rows + topology + outputs)
    ops = batch * (blocks * OPS_PER_BLOCK + words * OPS_PER_WORD)
    return nbytes, ops


def whole_round_work(shape: dict, batch: int) -> tuple:
    n, D, W, B, z0, K = (shape["n"], shape["degree"], shape["max_walks"], shape["rt_bins"],
                         shape["z0"], shape["bursts"])
    topology = n * D * (1 + 4 + 4 + 1) + n * (1 + 4 + 4 + 1 + 1)
    walks = W * ((4 + 4 + 1) + 4 * 4 + 4 * K + (4 + 1 + 4 + 1 + 1 + 1) + 4 * D + 4)
    rows = z0 * (4 * W + 2 * B + 4)
    ops = 3 * n * D
    return batch * (topology + walks + rows), batch * ops


def least_seconds(work: tuple) -> float:
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
