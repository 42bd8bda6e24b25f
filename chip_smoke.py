#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py               # the main path at 6300 of the paper's 9000 steps
    python3 chip_smoke.py --steps 300 --sweep-steps 300 --zoo-steps 600 --figure-steps 1000 \
        --rwsgd-steps 300
                                        # a quick pass through every phase

Every round of phases 3-5 and 7-11 replays a captured CUDA graph (the
Plan's executable cache, ``repro_torch.api.plan``), and every decode
step of phases 6 and 13 too (``launch.serve.DecodeGraph``); each captured run's
capture is timed apart from its replays, and short eager windows of the
same runs are timed beside them and held to them bitwise.

Phases, each printed on its own line (phase 14 runs right after phase 2,
while the card holds nothing of the others; phase 15 after phase 12,
phase 13 last):

1. device: nvidia-smi's name and power limit, torch's device name, and
   the build of the kernels' seven sources from ``src/repro_torch/csrc``
   (nvcc, sm_90a, one process per source, all at once), with each
   source's seconds; the bf16 attention library's and the bf16 SSD
   library's SASS must hold HGMMA (wgmma) instructions, and their
   registers and spills are printed;
2. kernels: each kernel against its plain PyTorch version on the card,
   on numpy-seeded inputs at its path's shapes. The round kernels
   bitwise (batch 50, n 100, C = W = 64, B = 1024, D = 8; whole_round
   also at phase 7's 200 rows; round_update / theta_sums also at
   n = 100,000, batch 1; whole_round and theta_sums also at phase 9's
   batch 8 on its other graphs: regular n 50 and 200, complete, Erdos-Renyi
   and power-law n 100; and at phase 15's widths and batch on Cayley
   graphs of n 262,144 and 1,048,576, past the ~231,000 nodes the kernel's
   one CTA per trajectory once held in shared memory); flash_attention at
   yi-6b's prefill (batch 4,
   S 512, H 32, KV 4, D 128, bf16, tolerance 3e-2; the same batch and S
   at D 64 and D 256), paper-rwsgd's (S 128, H 8, KV 4, D 32, f32, 2e-4),
   yi-6b's float32 gate's (its prefill's shape in f32, 2e-4) and a
   windowed shape (window 96, S 256, bf16), and phase 13's prefills in
   bf16 and in f32: hymba-1.5b (H 25, KV 5, D 64), dbrx-132b (H 48, KV 8,
   D 128), musicgen-large (H 32, KV 32, D 64) and qwen2-vl-2b (S 1,536:
   1,024 vision + 512 text; H 12, KV 2, D 128); ssd_intra_chunk at
   mamba2-1.3b's (batch 4, 2 chunks of 256, H 64, P 64, N 128) with bf16
   B / C (the served dtype, the row; tensor cores; 3e-4) and with f32 B /
   C (the float32 gate's; exact float32 on the CUDA cores, which must be
   bitwise its plain version), and at hymba-1.5b's (H 50, N 16) with both
   (3e-4).
   Median times by CUDA events: each kernel's from Python (``ms``: eager,
   the wrapper's host cost included, as since the first slice) and on the
   device alone (``device_ms``: the same calls replayed as a CUDA graph),
   the plain version's time (eager), the bound (the larger of the bytes
   over 3.35 TB/s and the operations over the rate of the unit that runs
   them: the tensor cores' for the bf16 kernels, the CUDA cores' 67
   TFLOP/s for the f32 ones) and, for attention, one ``scaled_dot_product_attention`` call on
   the same inputs (``library_ms`` eager, ``library_device_ms`` graph);
3. main path: the paper's DecAFork and DecAFork+ ensembles (regular
   graph n = 100, d = 8; Z0 = 10, W = 64, B = 1024, 50 seeds, bursts of
   5 and 6 walks at steps 2000 and 6000, decisions from step 1000; 6300
   of the paper's 9000 steps unless ``--steps`` says otherwise) through
   ``repro_torch.api.Experiment`` on ``cuda``, captured: ms per round of
   the replays, trajectory-rounds/s, capture seconds; the captured
   graph must hold one whole_round node (read from the graph), its
   launches must equal the rounds run plus the capture's warm-up round,
   and Z_t must survive near Z0. Then each ensemble's first 60 rounds
   through the eager loop (``run_rounds``), timed and held bitwise to
   the captured run, and a 20-round torch.profiler window of the
   captured round: the device's busy share, its kernels per round, and
   its whole_round launches, which must equal the rounds replayed and
   the wrapper counter's growth (a window from which the profiler drops
   a record repeats, up to three windows);
4. cross-device parity: 160 rounds, 4 seeds, churny failures, on cuda and
   on the CPU; integer outputs bitwise, theta_mean within 1e-6;
5. unfused paths, 160 rounds: ``round_impl="unfused"`` with
   ``estimator_impl`` = ``"fused"`` (round_update) and ``"pallas"``
   (theta_sums), one launch per round (and one in a capture's warm-up
   round); their integer outputs must equal the fused round's. Then
   DecAFork+ with ``auto_eps`` through theta_sums (the same count) and
   with the analytic survival (no kernel),
   200 steps, 4 seeds, cuda against the CPU: integers bitwise,
   theta_mean within 1e-6. Then captured against eager at full width
   (150 steps, 50 seeds, decisions from step 50, churny failures) for a
   fused group (DecAFork+), MissingPerson and auto_eps: outputs, final
   carry and theta_mean bitwise. Last, 8 captured rounds of each unfused
   path (round_update, theta_sums, auto_eps, MissingPerson) under
   torch.profiler: the device's launches of each kernel must equal one
   per round of the path's kernel (none for MissingPerson) and the
   counters' growth;
6. serve: ``repro_torch.launch.serve.generate`` on cuda for yi-6b
   (batch 4, prompt 512, 32 new tokens), mamba2-1.3b (the same) and
   paper-rwsgd (batch 4, prompt 128, 16 new tokens), at their published
   widths and depths with ``use_pallas=True`` and weights from
   ``Model.init`` (seed 0), in the served dtype: a first generate
   captures the decode step, the second is timed (captured decode
   tokens/s), then ``generate_eager`` (eager tokens/s), whose tokens must
   equal the captured ones; four eager decode steps, and the captured
   loop's replays, under torch.profiler give their kernels per step and
   busy share. Each prefill must launch its kernel
   once per layer (the plain path none). The gate runs the same weights
   in float32: the kernel path's last-position logits must match
   ``use_pallas=False`` (plain torch on the card) within
   ``F32_LOGIT_RTOL`` of the logit scale, and its greedy tokens must
   equal the plain run's wherever the plain run's top-2 logit gap
   exceeds that bound; the served dtype's gap is recorded, and for the
   SSM model the float32 gap with the intra-chunk block computed in
   float64 (how far an exact block lands from the plain path's float32
   rounding). The float32 kernel path's prefill ms (``f32_prefill_ms``)
   is read from the gate's generate;
7. sweep: Fig. 1's three curves (MissingPerson eps_mp 400, DecAFork eps
   2.0, DecAFork+) and Fig. 5's DecAFork eps grid (1.8, 2.0, 2.25, 2.5)
   as one ``Experiment(scenarios=...).sweep(seeds=50)`` on cuda, in the
   main path's configuration (6100 of its 9000 steps unless
   ``--sweep-steps`` says otherwise): three groups (DecAFork 200 rows, DecAFork+ 50,
   MissingPerson 50), each captured and timed as in phase 3 (ms per
   round, trajectory-rounds/s, the ratio to phase 3's DecAFork ensemble,
   capture seconds, an eager window held bitwise to it). The two
   DecAFork groups must decide fused, hold one whole_round node in their
   captured round and launch it once per round (and once in the capture's
   warm-up round); MissingPerson none at all (unfused, with the
   reference's reason); every DecAFork / DecAFork+ scenario must survive near Z0.
   Then parity at full width for 200 steps with decisions from step 50:
   each scenario of a cuda sweep equals its own cuda ensemble bitwise,
   and a 4-seed mixed sweep (the three algorithms and ``none``, churny
   failures) on cuda equals the same sweep on the CPU (integers bitwise,
   theta_mean within 1e-6). Then Fig. 5's DecAFork eps grid (4 scenarios
   x 50 seeds, 600 rounds) as one group on one device and split over
   ``cuda:0`` twice (``placement="sharded"`` with the placement's device
   list set so: two blocks, two runners, two captures, two host threads):
   bitwise, whole_round launched once per round per block plus each
   capture's warm-up round, each block's round one whole_round node; the
   second runs timed (ms per round, split against one device);
8. zoo: Fig. 9's grid at its full widths (``benchmarks/fig9_zoo.py``
   under ``BENCH_FULL=1``: community graph n 64, two bridges; DecAFork+
   Z0 10, eps 3.0 / 7.57, W 64, B 1024, decisions from step 1000; the
   defenses uniform / jump / biased / bloom against none / mobile Pac-Man
   (hop 0.5) / two Pac-Men (0, 32) / an edge cut at 32, every attack at
   step 2166; 16 seeds; 4500 steps there, cut to 2200 unless
   ``--zoo-steps`` says otherwise)
   through the port's ``figures.fig9_zoo`` experiment, one sweep on cuda:
   each group's decision and reason, captured ms per round,
   trajectory-rounds/s and capture seconds. No group may decide fused
   (whole_round never sees a variant, Pac-Man slots or an edge cut); each
   group's round must hold its kernel once (round_update) and launch it
   once per round plus its capture's warm-up round; the ``none`` rows
   must survive near Z0. Then the first 200 rounds x 4 seeds of every
   group on cuda against the CPU (its side computed by one spawned
   process while the card runs phases 7-9): integer outputs and the final carry (``prev``, ``bloom``,
   ``pacman_pos`` included) bitwise, theta_mean within 1e-6; and for a
   bloom group and a mobile Pac-Man group the captured run against the
   eager loop, bitwise;
9. figures: the port's drivers of Figs. 2, 3, 4, 6 and 7,
   ``theory_bounds`` and ``auto_eps`` (``repro_torch.figures``) on cuda at
   their reduced setting, cut to ``--figure-steps`` rounds (default
   2040); each row's CSV is printed and must be finite, and each kernel's
   launches must equal one per round of the groups whose path it is
   (whole_round in the fused groups, round_update in unfused DecAFork
   groups, theta_sums in ``auto_eps``'s auto runs) plus one warm-up round
   per new capture. Their result files go to
   ``chiprun_out/figures_smoke/``. Then each driver's groups, on its own
   graphs (Fig. 4's n 50 / 200, Fig. 6's complete, Erdos-Renyi and
   power-law, ``auto_eps``'s five) with decisions from step 20 and its
   bursts, Byzantine node, crash or Pac-Man moved inside the window, for
   their first 120 rounds x 2 seeds on cuda against the CPU (a scenario
   an earlier driver ran on the same graph is not rerun): integer
   outputs and the final carry bitwise, theta_mean within 1e-6;
10. payload: the RW-SGD workload, walks carrying model replicas trained
   by local AdamW steps (``optim.RwSgdPayload``). (a) The paper's
   training path at full width: ``examples/decentralized_training.py``'s
   defaults (regular graph n 64, d 8; DecAFork Z0 6, W 16, eps 1.2,
   decisions from step 400, a burst of 3 walks at step 900; 1400 steps
   there, cut to 1000 unless ``--rwsgd-steps`` says otherwise; ``adamw(3e-3)``, local batch
   2 x 32 tokens) with paper-rwsgd at its published width and depth (4
   layers, d 256, vocabulary 4096; 6,031,616 parameters a replica), 4
   seeds (64 replicas with their AdamW moments), captured: ms per round,
   trajectory-rounds/s, trained replica-steps/s and tokens/s, capture
   and init seconds, peak device memory; whole_round's launches must
   equal the rounds plus the capture's warm-up round (read from the
   graph), Z_t must survive the burst and the loss fall (the last 100
   rounds' mean under the first 100's). The first 25 rounds through the
   eager loop must be bitwise the captured run (integers, losses), and a
   captured 25-round run, run twice, bitwise the eager loop and itself
   (outputs and final replicas); 10 captured rounds under torch.profiler
   give the busy share and the kernels with the most device time. (b)
   The smoke config, 2 seeds, 60 rounds, decisions from step 20 and a
   burst at 40, captured on cuda against the spawned CPU process's run
   in 10-round legs: integers, ``trained`` and the final state bitwise;
   then each leg again on cuda from the CPU's state and replicas at its
   start: integers bitwise, its first round's per-slot losses within
   1e-5, ``mean_loss`` within 1e-3 in every round (free-running losses
   of two implementations drift further apart over 60 rounds: Adam's
   first steps follow the sign of the gradient; the drift is printed).
   (c) Fig. 8's driver at its ``BENCH_FULL``
   scale (4 seeds, 9 scenarios in 3 groups; 300 of its 900 steps, its
   decisions and failures at a third and a half of them): its rows printed,
   whole_round's launches counted as in phase 9, every DecAFork /
   DecAFork+ row still training at the end, at most 3 new cache slots.
   Phase 2 holds whole_round bitwise to its plain version at these
   paths' shapes (batch 4, n 64, D 8, W 16; batch 12, n 48, D 6, W 12);
11. durable execution and the service (``Plan.*_segmented``,
   ``ResultStore``, ``ExperimentService``). (a) Phase 3's DecAFork
   ensemble through ``Plan.ensemble_segmented(50, segment_steps=steps/9,
   store=ResultStore(chiprun_out/durable))`` in a spawned child process,
   which the parent SIGKILLs once the store holds an intact snapshot at
   4/9 of the run (2,800 of 6,300 steps); the parent then runs the same
   line, which must resume from the latest intact snapshot, capture no
   graph (phase 3's slot serves it), launch whole_round once per round it
   replays (read from the graph) and end bitwise phase 3's straight
   captured run; the step it resumed at, the bytes of each snapshot, the
   seconds of each boundary write and the ms per round against phase 3's
   are printed. (b) Phase 7's scenarios (Figs. 1 and 5) at 600 steps, 50
   seeds, decisions from step 50 and the bursts at 200 and 400, split
   over three caller threads that submit to one ``ExperimentService``
   (background worker, a store): they must coalesce into phase 7's three
   groups, one injected TransientFault at ``service.run_group`` must
   retry, each caller's rows must be bitwise a private ``sweep`` of its
   scenarios, the same submissions again must be store hits (no runner
   run, no capture), and the main thread launches CUDA work and
   synchronises on it throughout, during the worker's captures too. (c)
   Phase 10 (b)'s smoke-config payload run (2 seeds, 60 rounds) in
   segments of 20 with a SimulatedKill at the second boundary, then
   resumed: outputs, losses and final replicas bitwise the straight
   captured run;
12. sharded: the node-sharded protocol step
   (``repro_torch.core.distributed``; no kernel of ``repro_torch.kernels``
   on its path, and their counters must not move). (a) The reference's
   production protocol step (``launch/dryrun.py::build_protocol``:
   DecAFork+ Z0 16, eps 4.0 / 11.0, W 64, B 512, max degree 16) at its n
   131,072 on a Cayley graph of Z_n of degree 16 (offsets drawn from the
   seed: the port's generators fill a dense n x n adjacency), over NCCL at
   world size 1 (a ``FileStore``), 2000 rounds through ``run_sharded``,
   which captures the round as a CUDA graph over NCCL: the first 50
   rounds captured must be bitwise the same rounds eager and the same
   step on the CPU; ms per round over the last 1950 captured rounds (host
   clock ending in a synchronize) beside the eager loop's over 100 of
   them, the capture's seconds and kernel nodes, Z's range, peak device
   memory, the node tables' bytes, and 10 replays under torch.profiler
   (kernels per round, busy share). (b) Two spawned
   ranks over gloo on CUDA tensors (NCCL refuses two ranks on one
   device), a 16-regular Cayley graph of n 4,096, random node and link
   masks, 150 rounds: bitwise world size 1 on the same inputs;
13. families: phase 6's serving, measurements and gates for the moe,
   hybrid, audio and vlm families at their published widths, with
   ``use_pallas=True`` and weights from ``Model.init`` (seed 0), bf16,
   batch 4, 32 new tokens: hymba-1.5b (prompt 512; flash_attention and
   ssd_intra_chunk), musicgen-large (prompt 512 x 4 codebooks), qwen2-vl-2b
   (512 text tokens after its 1,024-token vision prefix, M-RoPE) at their
   published depths, and dbrx-132b and deepseek-v2-236b (MLA) cut to 1
   layer (their 40 / 60 layers of bf16 weights do not fit the card's 80
   GB). Each prefill must launch its kernels once per layer (deepseek-v2's
   none: its MLA prefill runs the plain attention, as in the reference, so
   it has no float32 kernel gate to run); captured decode tokens equal
   the eager loop's (the MoE step, routing and dispatch included, captured
   whole). Then each family's smoke config through ``generate`` on cuda
   and, with the same weights, on the CPU: prefill logits within 2e-4,
   greedy tokens equal up to a near tie;
14. train: ``repro_torch.launch.train.make_train_step`` with AdamW
   (``cosine_schedule(3e-4)``), ``adjust_config`` for ``train_4k``
   (remat on), ``use_pallas=False`` (neither model kernel has a
   backward, so no kernel of the port may launch in this phase), bf16
   weights from ``Model.init`` (seed 0), batches from ``make_markov_task``.
   (a) hymba-1.5b at its published width and depth, batch 4 x 1,024, 2
   microbatches, 20 steps: 3 eager (host-bound), then the donated step
   captured as a CUDA graph and replayed (its first replay's loss bitwise
   an eager step's from a copy of the state); (b) dbrx-132b at its published width, 1 of its
   40 layers (132 B parameters at full depth), batch 2 x 512, 10 steps,
   the update written in place (``donate=True``; its data over 8,192 of
   its token ids). Each: init s, ms per step, tokens/s, peak memory, the
   last step under torch.profiler (kernels per step, busy share), the
   first and last 5 losses (finite, and falling), the MoE's aux loss per
   step, and the first microbatch's loss with remat on against off
   (bitwise). (c) Each family's smoke config in float32 (granite-8b,
   mamba2-1.3b, hymba-1.5b, dbrx-132b, deepseek-v2-236b, musicgen-large,
   qwen2-vl-2b): one step (SGD) on cuda and on the CPU from the same
   weights: loss within 1e-5 relative, parameters within rtol 2e-4 / atol
   2e-5, the MoE's expert ids equal wherever the router's top-k margin
   exceeds 1e-6;
15. large graph: ``Experiment(...).ensemble(8)`` with phase 12's protocol
   (DecAFork+ Z0 16, eps 4.0 / 11.0, W 64, B 512) on a 16-regular Cayley
   graph of n 1,048,576 with light node and link churn,
   ``round_impl="auto"`` (the fused round: whole_round), captured, 200
   rounds: the decision, one whole_round node in the captured round and
   its launches (the replays plus the warm-up round), Z in [1, W], ms per
   round, trajectory-rounds/s, capture seconds, peak memory. Then 10
   rounds of the same cell at n 262,144, 8 seeds on cuda, row 0 against
   the spawned CPU process's 1-seed run of the same keys: integer outputs
   bitwise, the final carry's tables bitwise (SHA-256 of their bytes),
   theta_mean within 1e-6.

Before the last line it prints the card's name and power limit, then one
JSON object with every kernel's launches, error and times; the last line
is ``{"ok": true, "device": {...}}``. Any failed check raises. Without a
CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
OPS_PER_S = 67e12  # H100 SXM float32 / int32 outside the tensor cores
# H100 SXM dense tensor-core peaks by input type (data sheet): bf16, and
# TF32 for float32 inputs
TC_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
# kernel vs plain prefill logits in float32: max |diff| <= F32_LOGIT_RTOL *
# max |plain logit|. The two paths differ only in summation order there
# (4.6e-6 of the scale measured at yi-6b, 0 at mamba2-1.3b). In bf16 they
# round at different places in every layer (the plain attention casts its
# probabilities to bf16, the plain SSD takes C.B^T in bf16), and random
# weights amplify that through 32-48 layers, so the served dtype's gap is
# recorded and the gate is the float32 run of the same weights.
F32_LOGIT_RTOL = 1e-4
# phase 2's flash_attention shapes of phase 13's prefills (label, (B, S, H,
# KV, D, window, dtype)), served in bf16 and gated in f32: GQA ratios 5
# (hymba), 6 (dbrx, qwen2-vl) and 1 (musicgen); D 64 and 128; qwen2-vl's
# S of 1,024 vision + 512 text
FAMILY_ATTENTION = tuple(
    (f"{name} {'prefill' if dt == 'bfloat16' else 'float32 gate'}", shape + (dt,))
    for dt in ("bfloat16", "float32")
    for name, shape in (("hymba-1.5b", (4, 512, 25, 5, 64, 0)),
                        ("dbrx-132b", (4, 512, 48, 8, 128, 0)),
                        ("musicgen-large", (4, 512, 32, 32, 64, 0)),
                        ("qwen2-vl-2b", (4, 1536, 12, 2, 128, 0))))
SERVE = (  # arch, batch, prompt, new tokens
    ("yi_6b", 4, 512, 32),
    ("mamba2_1_3b", 4, 512, 32),
    ("paper_rwsgd", 4, 128, 16),
)
# phase 13: the moe, hybrid, audio and vlm families at their published
# widths (arch, batch, prompt tokens, new tokens, layers: None is the
# published depth); the MoE pair's 40 / 60 layers of bf16 weights (about
# 264 / 472 GB) do not fit the card's 80 GB, so they run 1 (2 until phase
# 14 came); qwen2-vl-2b's
# prompt is 512 text tokens after its 1,024-token vision prefix
FAMILIES = (
    ("hymba_1_5b", 4, 512, 32, None),
    ("musicgen_large", 4, 512, 32, None),
    ("qwen2_vl_2b", 4, 512, 32, None),
    ("dbrx_132b", 4, 512, 32, 1),
    ("deepseek_v2_236b", 4, 512, 32, 1),
)
FAMILY_SMOKE = (2, 64, 8)  # phase 13's smoke configs, cuda vs CPU: batch, prompt, new tokens
CPU_LOGIT_TOL = 2e-4  # their prefill logits, cuda vs CPU (the CPU parity tests' tolerance)
# phase 14: training (launch/train.py). (a) hymba-1.5b at its published
# width and depth; (b) dbrx-132b at its published width, 1 of its 40 layers
# (132 B parameters at full depth; 4.49 B at one layer, about 54 GB with
# bf16 gradients and float32 AdamW moments, updated in place), its data
# drawn over 8,192 of its 100,352 token ids (the Markov task's (V, V)
# logits at the whole vocabulary would take 40 GB)
TRAIN_RUNS = (  # dbrx first: it needs the most memory
    ("dbrx", dict(arch="dbrx_132b", layers=1, batch=2, seq=512, steps=10, microbatches=1,
                  warmup=3, donate=True, data_vocab=8192)),
    # 30 steps until phase 15 came
    ("hymba", dict(arch="hymba_1_5b", layers=None, batch=4, seq=1024, steps=20, microbatches=2,
                   warmup=10, donate=True, capture=True)),
)
# (a)'s eager steps before its step is captured (its eager step is
# host-bound: ~46,000 launches, busy ~19 %; the replays are not)
TRAIN_EAGER_STEPS = 3
TRAIN_FAMILIES = ("granite_8b", "mamba2_1_3b", "hymba_1_5b", "dbrx_132b", "deepseek_v2_236b",
                  "musicgen_large", "qwen2_vl_2b")  # (c): each family's smoke config
TRAIN_SMOKE = (4, 64)  # (c)'s batch and sequence (the vlm's counts its vision prefix)
TRAIN_LOSS_RTOL = 1e-5  # (c): loss, cuda vs CPU, relative
TRAIN_PARAM_TOL = (2e-4, 2e-5)  # (c): updated parameters (the reference's microbatch tolerance)
ROOT = os.path.dirname(os.path.abspath(__file__))

PAPER = dict(n=100, degree=8, z0=10, max_walks=64, rt_bins=1024, protocol_start=1000,
             bursts=(2000, 6000), burst_sizes=(5, 6), steps=9000, seeds=50)
# the default main-path length: the paper's 9000, cut to 6300 when phase 14
# came to hold the whole run under the tool's 1,200 s (both bursts, at 2000
# and 6000, still fire; phase 11 resumes it from 2800, 4/9 of it)
MAIN_STEPS = 6300
# the default sweep length: the paper's 9000, cut to 6100 when phase 14
# came to hold the whole run under the tool's 1,200 s (both bursts, at 2000
# and 6000, still fire)
SWEEP_STEPS = 6100
# eager rounds timed beside each captured run (phases 3 and 7), and
# captured rounds under the profiler (phase 3): 200 and 50 until phase 14
# came, then 100 and 20; the window 60 since phase 15
EAGER_WINDOW = 60
PROFILE_ROUNDS = 20
ALGS = {"decafork": dict(eps=2.0), "decafork+": dict(eps=3.0, eps2=7.57)}
EPS_MP = 400.0  # MissingPerson's timeout in benchmarks/common.py
EPS_GRID = (1.8, 2.0, 2.25, 2.5)  # Fig. 5's DecAFork grid (2.0 is Fig. 1's curve)
CHURN = dict(burst_times=(60, 140), burst_sizes=(5, 6), p_fail=0.002,
             byzantine_node=2, p_byz=0.05, byz_start_time=30,
             p_node_fail=0.01, p_node_recover=0.3, node_fail_start=20,
             p_link_fail=0.02, p_link_recover=0.4, link_fail_start=20,
             pacman_node=4, pacman_start_time=100,
             node_crash_times=(50,), node_crash_ids=(3,))
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
# phase 9's default rounds, cut from the drivers' reduced 4500 (to 2400,
# to 2100 when phase 13 came, then to 2040 beside phase 14) to hold the
# whole run under the tool's 1,200 s: the first burst (1500), Fig. 3's
# Byzantine phase (1800) and Fig. 7's crash and Pac-Man (2033) still fire,
# the second burst (3000) does not
FIGURE_STEPS = 2040
Z_BAND = (PAPER["z0"] / 2, 2 * PAPER["z0"])  # mean Z after the start must lie here
# phase 8: Fig. 9's grid as benchmarks/fig9_zoo.py sets it under BENCH_FULL=1
ZOO = dict(n=64, steps=4500, seeds=16, protocol_start=1000, parity_steps=200, parity_seeds=4)
# phase 8's default rounds, cut from Fig. 9's 4500 (to 3000 beside phase
# 10, to 2500 beside phase 13, then to 2200 beside phase 14) to hold the
# whole run under the tool's 1,200 s: the attacks (2166) still fire, 34
# rounds before the end
ZOO_STEPS = 2200
# phase 9: the port's figure drivers (name, module, the events of their
# parity window: decisions, bursts and each driver's own attack moved into
# its first FIGURE_PARITY rounds); Figs. 1 and 5 are phase 7
_EVENTS = dict(proto_start=20, bursts=(50, 90))
FIGURES = (("fig2", "fig2_probabilistic", _EVENTS),
           ("fig3", "fig3_byzantine", dict(proto_start=20, byz_at=35)),
           ("fig4", "fig4_nodes", _EVENTS), ("fig6", "fig6_graphs", _EVENTS),
           ("fig7", "fig7_topology", dict(proto_start=20, crash_at=50)),
           ("theory", "theory_bounds", _EVENTS),
           ("auto_eps", "auto_eps", dict(_EVENTS, auto_start=35)))
FIGURE_PARITY = dict(steps=120, seeds=2)  # rounds x seeds of phase 9's cuda-vs-CPU window
# the graphs phase 9 runs besides phase 3's (family, n, kwargs): Fig. 4's
# n 50 / 200, Fig. 6's complete, Erdos-Renyi and power-law (auto_eps's
# too); phase 2 holds whole_round and theta_sums to their plain versions
# on each at the drivers' batch
FIGURE_GRAPHS = (("regular", 50, dict(degree=8)), ("regular", 200, dict(degree=8)),
                 ("complete", 100, {}), ("erdos_renyi", 100, {}), ("power_law", 100, dict(m=4)))
FIGURE_BATCH = 8  # the drivers' seeds at their reduced setting
CPU_THREADS = 4  # torch threads of the process that runs the parity's CPU side
# phase 10: examples/decentralized_training.py's defaults, with paper-rwsgd
# at its published width and depth (configs/paper_rwsgd.py) in place of
# its smoke config; 4 seeds, captured
RWSGD = dict(n=64, degree=8, z0=6, max_walks=16, eps=1.2, protocol_start=400, rt_bins=512,
             burst_at=900, burst_size=3, steps=1400, seeds=4, lr=3e-3, local_batch=2, seq=32)
RWSGD_EAGER = 25  # eager rounds held to the captured run (phase 10 a; 50 until phase 14)
RWSGD_PROFILE = 10  # captured rounds under torch.profiler (phase 10 a)
# phase 10 b: the smoke config on cuda and on the CPU, decisions and the
# burst inside the window so forks copy replicas in it
RWSGD_PARITY = dict(steps=60, seeds=2, protocol_start=20, burst_at=40, leg=10)
# mean_loss per round, cuda vs CPU over a leg (tests/test_torch_payload.py's
# bound, there over a 20-round window)
RWSGD_LOSS_BOUND = 1e-3
# benchmarks/fig8_learning.py under BENCH_FULL=1 (900 steps), cut to 300
# when phase 14 came
FIG8_FULL = dict(steps=300, seeds=4)
# phase 10 (a)'s default rounds: the example's 1400, cut to 1000 when phase
# 14 came (the burst at 900 still fires; the loss gate compares the first
# and last 100 rounds)
RWSGD_STEPS = 1000
# whole_round's shapes on phase 10's paths (batch, n, degree, W, bins):
# the training run's 4 seeds, Fig. 8's groups (3 scenarios x 4 seeds)
PAYLOAD_SHAPES = ((4, 64, 8, 16, 512), (12, 48, 6, 12, 256))
CPU_TIMEOUT_S = 600  # the longest phases 8 and 9 wait for that process's result
# phase 12: the reference's production protocol step (launch/dryrun.py::
# build_protocol: DecAFork+ Z0 16, eps 4.0 / 11.0, W 64, B 512, max degree
# 16, n 131,072) on a Cayley graph of that n, eager, its first
# ``cpu_rounds`` held bitwise to the CPU; then two ranks over gloo on the
# card against world size 1 on a 16-regular Cayley graph of n 4,096 with
# random masks
# rounds: 2000 eager until phase 14 came, then 500; captured, 2000 again
SHARDED = dict(n=131072, degree=16, z0=16, max_walks=64, eps=4.0, eps2=11.0, rt_bins=512,
               rounds=2000, cpu_rounds=50)
SHARDED_RANKS = dict(n=4096, degree=16, rounds=150, world=2)  # rounds: 300 until phase 14
SHARDED_PROFILE = 10  # captured rounds of (a) under torch.profiler
SHARDED_EAGER = 100  # eager rounds of (a) timed beside the captured ones
# phase 15: the large-graph main path. SHARDED's protocol (DecAFork+ Z0 16,
# eps 4.0 / 11.0, W 64, B 512) on a 16-regular Cayley graph of n 1,048,576
# (past the ~231,000 nodes whole_round's one CTA per trajectory once held
# in shared memory) with light node and link churn, 8 seeds, captured;
# the card's integers held to a CPU run of the same inputs over a
# ``window`` of rounds at 1 seed at n 262,144 (the CPU's threefry over the
# 16.8 M edge uniforms a round at n 1,048,576 takes ~14 s); whole_round
# at ``kernel_n`` in phase 2
LARGE = dict(n=1_048_576, seeds=8, rounds=200, window_n=262_144, window=10,
             kernel_n=(262_144, 1_048_576))
LARGE_CHURN = dict(p_node_fail=1e-4, p_node_recover=0.3, p_link_fail=1e-4, p_link_recover=0.4)
# phase 7 (c): Fig. 5's DecAFork eps grid (4 scenarios x 50 seeds) split
# over ``cuda:0`` twice (two blocks, two runners, two host threads) against
# the one-device sweep
SPLIT = dict(steps=600, devices=2)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, groups: int = 7, graph: bool = False) -> float:
    """Median over ``groups`` of the mean time of ``reps`` calls, by CUDA
    events, after one warm-up call. With ``graph`` the ``reps`` calls are
    captured once as a CUDA graph and each group replays it, so the time
    is the device's alone: a kernel whose wrapper costs the host more
    than the kernel costs the device is otherwise timed by the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want) -> float:
    """Largest absolute difference over a tuple of outputs (0.0 when
    bitwise); raises unless every output is bitwise equal."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.device != w.device:
            g, w = g.cpu(), w.cpu()
        if g.dtype.is_floating_point:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"output {i} differs from the plain version (max |err| {err})")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def observation_inputs(rng, batch, n, C, B, W, t, dev):
    """A mid-trajectory observation round (as the reference's
    ``random_round_inputs``): counts, last-seen times, walk events."""
    import numpy as np
    import torch

    ls = rng.integers(-1, t, (batch, n, C)).astype(np.int32)
    hist = np.floor(rng.random((batch, n, B)) * 3).astype(np.int16)
    total = hist.sum(axis=2, dtype=np.int32)
    pos = rng.integers(0, n, (batch, W)).astype(np.int32)
    track = np.stack([rng.permutation(C)[:W] for _ in range(batch)]).astype(np.int32)
    active = rng.random((batch, W)) < 0.8
    prev = np.take_along_axis(ls, pos[..., None], 1)[..., 0]
    prev = np.take_along_axis(prev, track, 1)
    r = (t - prev).astype(np.int32)
    valid = active & (prev != -1) & (r >= 1)
    upd = np.where(active, t, -1).astype(np.int32)
    tt = np.full((batch,), t, np.int32)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if int(C) * int(total.max()) >= 2**24:
        raise AssertionError("node-sum inputs break the exact-integer condition C * total < 2**24")
    return tuple(to(a) for a in (ls, hist, total, pos, track, r, valid, upd, tt))


def whole_round_inputs(rng, batch, n, C, B, D, W, K, graph, dev):
    """A churny whole round: partial masks, live uniforms, a firing burst."""
    import numpy as np
    import torch

    ls, hist, total, pos, track, _r, _v, _u, tt = observation_inputs(
        rng, batch, n, C, B, W, 70, dev
    )
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f32 = lambda *s: to(rng.random(s).astype(np.float32))  # noqa: E731
    nbrs = to(graph.neighbors.astype(np.int32))
    degs = to(graph.degrees.astype(np.int32))
    node_up = to(rng.random((batch, n)) < 0.9)
    edge_up = to(rng.random((batch, n, D)) < 0.9)
    active = to(rng.random((batch, W)) < 0.8)
    bsz = to(rng.integers(0, 4, (batch, K)).astype(np.int32))
    sched = to(rng.random((batch, n)) < 0.02)
    params_f = np.tile(np.array([0.05, 0.05, 0.05, 0.3, 0.4, 3.0, 7.57, 0.1], np.float32), (batch, 1))
    params_i = np.tile(np.array([70, 2, 4, 1], np.int32), (batch, 1))
    return (ls, hist, total, node_up, edge_up, pos, track, active, nbrs, degs,
            f32(batch, W), f32(batch, W), f32(batch, W), f32(batch, W),
            f32(batch, K, W), bsz, f32(batch, n), f32(batch, n), sched,
            f32(batch, n, D), f32(batch, n, D), to(params_f), to(params_i))


def large_whole_round_inputs(n, dev, batch=LARGE["seeds"], seed=0):
    """:func:`whole_round_inputs` at SHARDED's widths (W = C 64, B 512,
    degree 16) on a Cayley graph of ``n`` nodes, drawn on the card from a
    seeded generator: numpy's draws of the (batch, n, B) histogram would
    take tens of GB of host memory at n 1,048,576."""
    import torch

    W = C = SHARDED["max_walks"]
    B, D, K = SHARDED["rt_bins"], SHARDED["degree"], 2
    gen = torch.Generator(device=dev).manual_seed(seed + n)
    uni = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    ints = lambda lo, hi, *s, dtype=torch.int32: torch.randint(  # noqa: E731
        lo, hi, s, generator=gen, device=dev, dtype=dtype)
    g = cayley_graph(n, D, seed)
    hist = ints(0, 3, batch, n, B, dtype=torch.int16)
    params_f = torch.tensor([0.05, 0.05, 0.05, 0.3, 0.4, 3.0, 7.57, 0.1],
                            device=dev).repeat(batch, 1)
    params_i = torch.tensor([70, 2, 4, 1], dtype=torch.int32, device=dev).repeat(batch, 1)
    return (ints(-1, 70, batch, n, C), hist, hist.sum(2, dtype=torch.int32),
            uni(batch, n) < 0.9, uni(batch, n, D) < 0.9, ints(0, n, batch, W),
            torch.arange(W, dtype=torch.int32, device=dev).repeat(batch, 1),
            uni(batch, W) < 0.8, torch.as_tensor(g.neighbors, device=dev),
            torch.as_tensor(g.degrees, device=dev), uni(batch, W), uni(batch, W),
            uni(batch, W), uni(batch, W), uni(batch, K, W), ints(0, 4, batch, K),
            uni(batch, n), uni(batch, n), uni(batch, n) < 0.02, uni(batch, n, D),
            uni(batch, n, D), params_f, params_i)


def whole_round_bytes(x) -> int:
    """Bytes whole_round must move on inputs ``x`` (its argument tuple):
    the topology tables and uniforms in and the new ones out (11 bytes a
    node, 10 an edge), the walk vectors, and the rows the walks visit
    (last_seen, hist, total read; outputs written). The count is the
    function's: the node-tiled topology launch and the per-trajectory
    launch that reads its node liveness back from L2 move more."""
    bt, n, C = x[0].shape
    B, D, W, K = x[1].shape[2], x[4].shape[2], x[5].shape[1], x[14].shape[1]
    visited = sum(len(set(p.tolist())) for p in x[5].cpu())
    return (bt * (n * D * (1 + 4 + 4 + 1) + n * (1 + 4 + 4 + 1 + 1))
            + bt * W * (4 * 8 + 4 * K + D * 8)
            + visited * (C * 4 + B * 2 + 4))


def whole_round_ops(x) -> int:
    """Simple operations of whole_round on ``x``: three an edge, and the
    walks' hop, burst ranks, choose and theta rows."""
    bt, n, C = x[0].shape
    B, D, W, K = x[1].shape[2], x[4].shape[2], x[5].shape[1], x[14].shape[1]
    return bt * (3 * n * D + W * (4 * D + (1 + K) * W + B + 2 * C))


def obs_bytes(batch, n, C, B, W, sums_rows) -> int:
    """Bytes the observation pass must move: the W walk vectors, and the
    last_seen / hist / total of every row whose node sum it returns, plus
    those sums (float32)."""
    return batch * (W * 4 * 6 + sums_rows * (C * 4 + B * 2 + 4 + 4))


def check_kernels(rng, graph, dev, large_n=100_000):
    import torch

    from repro_torch.graphs import make_graph
    from repro_torch.kernels import (
        round_update, round_update_plain, theta_sums, theta_sums_plain,
        whole_round, whole_round_plain,
    )

    clone = lambda xs: tuple(x.clone() for x in xs)  # noqa: E731
    cpu = lambda xs: tuple(x.cpu() for x in xs)  # noqa: E731
    rows = []
    batch, n, C, B, D, W, K = 50, 100, 64, 1024, 8, 64, 2

    def entry(name, source, replaces, err, fn, plain_ms, nbytes, nops, shape, reps):
        """Times ``fn`` (the kernel's wrapper) eagerly from Python and on
        the device alone (graph replay). The bound is the larger of bytes
        over HBM bandwidth and simple (integer / float32) operations over
        the non-tensor-core rate."""
        ms = cuda_ms(fn, reps)
        device_ms = cuda_ms(fn, reps, graph=True)
        bound, by = core_bound(nbytes, nops)
        log("kernels", kernel=name, shape=shape, max_abs_err=err, ms=f"{ms:.6f}",
            device_ms=f"{device_ms:.6f}", plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound:.6f}",
            bound_by=by, bytes=nbytes, ops=nops)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None, library_device_ms=None,
                    shape=shape, bytes=nbytes, ops=nops)

    for shape in ((batch, n), (1, large_n)):
        bt, nn = shape
        x = observation_inputs(rng, bt, nn, C, B, W, 70, dev)
        ls, hist, total, t = x[0], x[1], x[2], x[8]
        # theta_sums: plain version on the card and on the CPU, kernel
        want = theta_sums_plain(ls, hist, total, t)
        err = max_abs_err((theta_sums(ls, hist, total, t),), (want,))
        if nn == n:  # the CPU's plain version agrees with the card's
            max_abs_err((theta_sums_plain(*cpu((ls, hist, total, t))),), (want,))
        reps = 50 if nn == n else 5
        plain_ms = cuda_ms(lambda: theta_sums_plain(ls, hist, total, t), 1, 3)
        ent = entry("theta_sums", "src/repro_torch/csrc/theta_sums.cu",
                    "src/repro/kernels/theta_survival.py:52", err,
                    lambda: theta_sums(ls, hist, total, t), plain_ms,
                    obs_bytes(bt, nn, C, B, 0, nn), bt * nn * (B + 2 * C), f"batch={bt},n={nn}",
                    reps)
        if nn == n:
            rows.append(ent)
        else:
            rows[0]["large"] = ent
        # round_update: in place, so each version gets its own copy
        got = round_update(*clone(x))
        want = round_update_plain(*clone(x))
        err = max_abs_err(got, want)
        work = clone(x)
        plain_ms = cuda_ms(lambda: round_update_plain(*work), 1, 3)
        ent = entry("round_update", "src/repro_torch/csrc/round_update.cu",
                    "src/repro/kernels/round_update.py:163", err, lambda: round_update(*work),
                    plain_ms, obs_bytes(bt, nn, C, B, W, nn), bt * (nn * (B + 2 * C) + 4 * W),
                    f"batch={bt},n={nn}", reps)
        if nn == n:
            rows.append(ent)
        else:
            rows[1]["large"] = ent

    # whole_round at the main path's shapes (both algorithms), then at
    # phase 7's 200-row DecAFork group (two waves over the 132 SMs)
    for bt in (batch, 200):
        x = whole_round_inputs(rng, bt, n, C, B, D, W, K, graph, dev)
        for plus in (False, True):
            got = whole_round(*clone(x), decafork_plus=plus)
            want = whole_round_plain(*clone(x), plus)
            err = max_abs_err(got, want)
            if bt == batch:
                max_abs_err(whole_round_plain(*cpu(clone(x)), plus), want)
        work = clone(x)
        plain_ms = cuda_ms(lambda: whole_round_plain(*work, True), 1, 3)
        ent = entry("whole_round", "src/repro_torch/csrc/whole_round.cu",
                    "src/repro/kernels/round_update.py:442", err,
                    lambda: whole_round(*work, decafork_plus=True), plain_ms,
                    whole_round_bytes(x), whole_round_ops(x), f"batch={bt},n={n}", 50)
        if bt == batch:
            rows.append(ent)
        else:
            rows[-1]["batch200"] = ent

    # whole_round at phase 15's widths and batch on Cayley graphs past the
    # ~231,000 nodes its one CTA per trajectory once held in shared memory
    # (n 262,144 and 1,048,576; the tables take up to 11 GB a copy), both
    # algorithms bitwise, compared on the card
    for nn in LARGE["kernel_n"]:
        x = large_whole_round_inputs(nn, dev)
        err = max(max_abs_err(whole_round(*clone(x), decafork_plus=plus),
                              whole_round_plain(*clone(x), plus)) for plus in (False, True))
        nbytes, nops = whole_round_bytes(x), whole_round_ops(x)
        work = x
        del x
        plain_ms = cuda_ms(lambda: whole_round_plain(*work, True), 1, 3)
        ent = entry("whole_round", "src/repro_torch/csrc/whole_round.cu",
                    "src/repro/kernels/round_update.py:442", err,
                    lambda: whole_round(*work, decafork_plus=True), plain_ms, nbytes, nops,
                    f"cayley,batch={LARGE['seeds']},n={nn},D={SHARDED['degree']},"
                    f"W={SHARDED['max_walks']},B={SHARDED['rt_bins']}", 10)
        rows[2].setdefault("large_n", []).append(ent)
        del work
        torch.cuda.empty_cache()

    # whole_round and theta_sums on phase 9's other graphs at its batch (the
    # drivers' 8 seeds), bitwise their plain versions on the card
    for fam, nn, kw in FIGURE_GRAPHS:
        g = make_graph(fam, nn, seed=0, **kw)
        x = whole_round_inputs(rng, FIGURE_BATCH, nn, C, B, g.max_degree, W, K, g, dev)
        err = max(max_abs_err(whole_round(*clone(x), decafork_plus=plus),
                              whole_round_plain(*clone(x), plus)) for plus in (False, True))
        x = observation_inputs(rng, FIGURE_BATCH, nn, C, B, W, 70, dev)
        ls, hist, total, t = x[0], x[1], x[2], x[8]
        err_ts = max_abs_err((theta_sums(ls, hist, total, t),),
                             (theta_sums_plain(ls, hist, total, t),))
        shape = f"{fam},batch={FIGURE_BATCH},n={nn},D={g.max_degree}"
        for r, e in ((rows[2], err), (rows[0], err_ts)):
            r.setdefault("figure_graphs", []).append(dict(shape=shape, max_abs_err=e))
        log("kernels", kernel="whole_round,theta_sums", shape=shape, max_abs_err=max(err, err_ts),
            bitwise=True)

    # whole_round at phase 10's shapes (both algorithms), bitwise
    for bt, nn, deg, w, b in PAYLOAD_SHAPES:
        g = make_graph("regular", nn, seed=0, degree=deg)
        x = whole_round_inputs(rng, bt, nn, w, b, deg, w, K, g, dev)
        err = max(max_abs_err(whole_round(*clone(x), decafork_plus=plus),
                              whole_round_plain(*clone(x), plus)) for plus in (False, True))
        shape = f"regular,batch={bt},n={nn},D={deg},W={w},B={b}"
        rows[2].setdefault("payload_shapes", []).append(dict(shape=shape, max_abs_err=err))
        log("kernels", kernel="whole_round", shape=shape, max_abs_err=err, bitwise=True)
    return rows


def sass_check(source):
    """The tensor-core library of ``source`` holds wgmma (HGMMA in its
    SASS, read by cuobjdump beside nvcc); returns the counts of HGMMA and
    of TMA / bulk copies (UTMALDG, UBLKCP) and the compiler's register /
    spill lines."""
    from pathlib import Path

    from repro_torch.kernels import _build

    lib = _build._lib_path(source)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    out = dict(hgmma=sass.count("HGMMA"), utmaldg=sass.count("UTMALDG"),
               ublkcp=sass.count("UBLKCP"), ptxas=ptxas)
    log("device", library=source, sass_HGMMA=out["hgmma"], UTMALDG=out["utmaldg"],
        UBLKCP=out["ublkcp"], ptxas=repr("; ".join(ptxas)))
    if out["hgmma"] == 0:
        raise AssertionError(f"{source}: no HGMMA in the SASS (wgmma not issued)")
    return out


def core_bound(nbytes, nops):
    """(bound ms, "bytes" or "operations"): bytes over HBM bandwidth
    against simple (integer / float32) operations over the rate outside
    the tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound(nbytes, flops, dtype_name):
    """(bound ms, "bytes" or "operations"): bytes over HBM bandwidth
    against FLOPs over the tensor-core peak for the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TC_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, window):
    """The one PyTorch call that computes the same attention, on (B, H,
    S, D) views of the model-layout tensors; a sliding window goes in as
    a boolean mask. A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    if window > 0:
        S = q.shape[1]
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def check_model_kernels(rng, dev):
    """flash_attention and ssd_intra_chunk against their plain versions
    at the serve path's shapes; the first shape of each is its row."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention, flash_attention_plain

    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)  # noqa: E731
    rows = {}
    for label, (B, S, H, KV, D, window, dt) in (
        ("yi-6b prefill", (4, 512, 32, 4, 128, 0, "bfloat16")),
        ("paper-rwsgd prefill", (4, 128, 8, 4, 32, 0, "float32")),
        ("yi-6b float32 gate", (4, 512, 32, 4, 128, 0, "float32")),
        ("window 96", (4, 256, 32, 4, 128, 96, "bfloat16")),
        ("D 64", (4, 512, 32, 4, 64, 0, "bfloat16")),
        ("D 256", (4, 512, 32, 4, 256, 0, "bfloat16")),
        *FAMILY_ATTENTION,
    ):
        dtype = getattr(torch, dt)
        q, k, v = f32(B, S, H, D).to(dtype), f32(B, S, KV, D).to(dtype), f32(B, S, KV, D).to(dtype)
        got = flash_attention(q, k, v, window=window)
        want = flash_attention_plain(q, k, v, window)
        tol = 2e-4 if dt == "float32" else 3e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        err = float((got.float() - want.float()).abs().max())
        ms = cuda_ms(lambda: flash_attention(q, k, v, window=window), 20)
        device_ms = cuda_ms(lambda: flash_attention(q, k, v, window=window), 20, graph=True)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, window), 3, 3)
        lib_ms = cuda_ms(sdpa_call(q, k, v, window), 20)
        lib_device_ms = cuda_ms(sdpa_call(q, k, v, window), 20, graph=True)
        i = np.arange(S)
        valid = (i[None, :] <= i[:, None]) & ((i[None, :] > i[:, None] - window) if window else True)
        flops = 4 * D * int(valid.sum()) * B * H  # Q.K^T and P.V over the valid pairs
        nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * q.element_size()
        # bf16 runs on the tensor cores; f32 stays exact on the CUDA cores
        bound, by = tc_bound(nbytes, flops, dt) if dt == "bfloat16" else core_bound(nbytes, flops)
        shape = f"B={B},S={S},H={H},KV={KV},D={D},window={window},{dt}"
        log("kernels", kernel="flash_attention", case=repr(label), shape=shape, max_abs_err=err,
            tol=tol, ms=f"{ms:.6f}", device_ms=f"{device_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            sdpa_ms=f"{lib_ms:.6f}", sdpa_device_ms=f"{lib_device_ms:.6f}",
            bound_ms=f"{bound:.6f}", bound_by=by, bytes=nbytes, flops=flops)
        src = "flash_attention_sm90.cu" if dt == "bfloat16" else "flash_attention.cu"
        ent = dict(name="flash_attention", route="cuda", source=f"src/repro_torch/csrc/{src}",
                   replaces="src/repro/kernels/flash_attention.py:75", max_abs_err=err, ms=ms,
                   device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=lib_ms, library_device_ms=lib_device_ms, shape=shape,
                   bytes=nbytes, flops=flops, tol=tol, case=label)
        if "flash_attention" in rows:
            rows["flash_attention"].setdefault("other_shapes", []).append(ent)
        else:
            rows["flash_attention"] = ent

    # mamba2-1.3b (the row) and hymba-1.5b, prompt 512: (label, B, nc, Q, H,
    # P, N, whether the f32 kernel must be bitwise its plain version)
    for label, *shape, bitwise in (("mamba2-1.3b prefill", 4, 2, 256, 64, 64, 128, True),
                                   ("hymba-1.5b prefill", 4, 2, 256, 50, 64, 16, False)):
        ssd_rows(rows, label, f32, *shape, bitwise)
    return [rows["flash_attention"], rows["ssd_intra_chunk"]]


def ssd_rows(rows, label, f32, B, nc, Q, H, P, N, bitwise):
    """ssd_intra_chunk against its plain version at one shape, with bf16 B
    / C (the served dtype) and f32 (the float32 gate's; bitwise where
    ``bitwise``, else within 3e-4), into ``rows``."""
    import torch

    from repro_torch.kernels import ssd_intra_chunk, ssd_intra_chunk_plain

    x = f32(B, nc, Q, H, P)
    da = torch.cumsum(-torch.nn.functional.softplus(f32(B, nc, Q, H)) * torch.exp(f32(H)), dim=2)
    b, c = f32(B, nc, Q, N), f32(B, nc, Q, N)
    tri = Q * (Q + 1) // 2
    # C.B^T once per chunk; per head y = W.x over t <= q and the state B^T.(x scaled)
    flops = B * nc * (2 * N * tri + H * (2 * P * tri + 2 * P * N * Q))
    for dt in ("bfloat16", "float32"):  # the served dtype (the row), then the float32 gate's
        bd, cd = b.to(getattr(torch, dt)), c.to(getattr(torch, dt))
        got = ssd_intra_chunk(x, da, bd, cd)
        want = ssd_intra_chunk_plain(x, da, bd, cd)
        if dt == "float32" and bitwise:
            # mamba2-1.3b's float32 gate needs the plain version's rounding
            err, tol = max_abs_err(got, want), 0.0
        else:
            err, tol = 0.0, 3e-4
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=tol, atol=tol)
                err = max(err, float((g - w).abs().max()))
        ms = cuda_ms(lambda: ssd_intra_chunk(x, da, bd, cd), 20)
        device_ms = cuda_ms(lambda: ssd_intra_chunk(x, da, bd, cd), 20, graph=True)
        plain_ms = cuda_ms(lambda: ssd_intra_chunk_plain(x, da, bd, cd), 3, 3)
        nbytes = B * nc * (Q * H * P * 4 * 2 + Q * H * 4 + 2 * Q * N * bd.element_size()
                           + H * P * N * 4)
        # bf16 B / C run on the tensor cores (TF32 products); float32 B / C
        # stay exact on the CUDA cores (the float32 serving gate needs it)
        bound, by = (tc_bound(nbytes, flops, "float32") if dt == "bfloat16"
                     else core_bound(nbytes, flops))
        shape = f"B={B},nc={nc},Q={Q},H={H},P={P},N={N},x f32,B/C {dt}"
        log("kernels", kernel="ssd_intra_chunk", case=repr(label), shape=shape, max_abs_err=err,
            tol=tol, ms=f"{ms:.6f}", device_ms=f"{device_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            bound_ms=f"{bound:.6f}", bound_by=by, bytes=nbytes, flops=flops)
        src = "ssd_intra_chunk_sm90.cu" if dt == "bfloat16" else "ssd_intra_chunk.cu"
        ent = dict(
            name="ssd_intra_chunk", route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces="src/repro/kernels/ssd_scan.py:53", max_abs_err=err, ms=ms,
            device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            library_device_ms=None, shape=shape, bytes=nbytes, flops=flops, tol=tol, case=label)
        if "ssd_intra_chunk" in rows:
            rows["ssd_intra_chunk"].setdefault("other_shapes", []).append(ent)
        else:
            rows["ssd_intra_chunk"] = ent


# ---------------------------------------------------------------------------
# phase 6: serving the registry's models through the kernels
# ---------------------------------------------------------------------------


def greedy_plain(model, params, batch, new):
    """The plain path's greedy tokens and, per step, the top-2 logit gap
    of the logits each token was chosen from, (B, new[, nq]) each, with
    the decode cache sized as ``generate`` sizes it."""
    import torch

    from repro_torch.launch.serve import expand_cache

    last, cache = model.prefill(params, batch)
    cache = expand_cache(model, cache, batch["tokens"].shape[1] + new + 1)
    toks, gaps, logits = [], [], last.clone()
    for i in range(new):
        top = torch.topk(logits[:, 0].float(), 2, dim=-1).values
        gaps.append(top[..., 0] - top[..., 1])
        toks.append(torch.argmax(logits[:, 0], dim=-1).to(torch.int32))
        if i < new - 1:
            logits, cache = model.decode_step(params, cache, {"tokens": toks[-1][:, None]})
    return last, torch.stack(toks, 1), torch.stack(gaps, 1)


def path_kernels(cfg):
    """The model kernels a prefill of ``cfg`` launches once per layer under
    ``use_pallas``: flash_attention for attention (not MLA's, which runs
    the plain attention, as in the reference), ssd_intra_chunk for the
    SSM mixer (the ssm and hybrid families)."""
    from repro_torch.kernels import flash_attention, ssd_intra_chunk

    out = []
    if cfg.arch_type != "ssm" and not cfg.use_mla:
        out.append(flash_attention)
    if cfg.arch_type in ("ssm", "hybrid"):
        out.append(ssd_intra_chunk)
    return tuple(out)


def prefill_launches(model, params, batch, what):
    """Last-position logits of one prefill, checking that it launched each
    kernel of its path once per layer and no other model kernel (none at
    all on the plain path)."""
    from repro_torch.kernels import flash_attention, ssd_intra_chunk

    cfg = model.cfg
    on_path = path_kernels(cfg) if cfg.use_pallas else ()
    before = {k: k.launches for k in (flash_attention, ssd_intra_chunk)}
    last, _ = model.prefill(params, batch)
    for k, n in before.items():
        want = cfg.num_layers if k in on_path else 0
        if k.launches - n != want:
            raise AssertionError(f"{what}: {k.__name__} launched {k.launches - n} times in one "
                                 f"prefill, expected {want}")
    return last


def ssd_in_f64_gap(model, params, batch, plain32):
    """The float32 prefill logits' gap to the plain path when the SSD
    intra-chunk block is computed in float64 (then rounded to float32)
    instead of by the kernel: how far an exact block lands from the plain
    path's float32 rounding. Recorded, not gated."""
    import torch

    from repro_torch.kernels import ops

    def block_f64(x, da, b, c):
        x, da, b, c = x.double(), da.double(), b.double(), c.double()
        Q = x.shape[2]
        tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        diff = da[:, :, :, None, :] - da[:, :, None, :, :]
        decay = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e30))
        y = torch.einsum("bcqth,bcthp->bcqhp",
                         torch.einsum("bcqn,bctn->bcqt", c, b)[..., None] * decay, x)
        st = torch.einsum("bctn,bcthp->bchpn", b, x * torch.exp(da[:, :, -1:, :] - da)[..., None])
        return y.float(), st.float()

    kern = ops.ssd_intra_chunk
    ops.ssd_intra_chunk = block_f64
    try:
        last, _ = model.prefill(params, batch)
    finally:
        ops.ssd_intra_chunk = kern
    return float((last - plain32).abs().max())


def profile_decode(model, params, batch, steps=4):
    """One eager decode step (decode_step plus greedy sampling) under
    torch.profiler, ``steps`` times after a warm-up step: CUDA kernels per
    step, their device ms per step and the busy share (kernel time over
    the profiled wall time)."""
    import torch

    from repro_torch.launch.serve import expand_cache

    last, cache = model.prefill(params, batch)
    cache = expand_cache(model, cache, batch["tokens"].shape[1] + steps + 2)
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    logits, cache = model.decode_step(params, cache, {"tokens": tok})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)

    def run():
        nonlocal tok, cache
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, {"tokens": tok})
            tok = torch.argmax(logits, dim=-1).to(torch.int32)

    _seen, events, wall_us = device_launches(run)
    return _busy(events, wall_us, steps)


def _busy(events, wall_us, steps):
    busy = sum(e.self_device_time_total for e in events)
    return dict(steps=steps, kernels_per_step=sum(e.count for e in events) / steps,
                kernel_ms_per_step=busy / steps / 1e3, wall_ms_per_step=wall_us / steps / 1e3,
                busy_share=busy / wall_us)


def profile_decode_captured(model, params, batch, new):
    """The captured decode loop under torch.profiler: a prefill (outside
    the window) into the model's one ``DecodeGraph``, then its ``new`` - 1
    replays, greedy. Kernels per step (the graph's nodes, attributed),
    their device ms per step and the busy share over the replays' wall
    time."""
    import torch

    from repro_torch.launch.serve import expand_cache
    from repro_torch.utils import prng

    (runner,) = model.decode_graphs.values()
    last, cache = model.prefill(params, batch)
    expand_cache(model, cache, batch["tokens"].shape[1] + new + 1, out=runner.cache)
    del cache
    tok = torch.argmax(last, dim=-1).to(torch.int32).reshape(runner.bufs["tok"].shape)
    key = prng.key(0, device=tok.device)
    _seen, events, wall_us = device_launches(lambda: runner.run(model, params, tok, key, 0))
    out = _busy(events, wall_us, new - 1)
    out["graph_kernel_nodes"] = runner.graph.kernel_nodes
    return out


def token_gate(gen, want, gaps, bound, what):
    """``gen``'s greedy tokens (B, new[, nq]) equal ``want``'s up to each
    stream's first step whose top-2 gap (the smallest over codebooks) is
    within ``bound`` (a legitimate flip; the streams' contexts differ
    after it). Returns (steps compared, streams stopped at a near tie)."""
    B, new = gaps.shape[:2]
    gaps = gaps.reshape(B, new, -1).amin(-1)
    compared, ties = 0, 0
    for b in range(B):
        for i in range(new):
            if float(gaps[b, i]) <= bound:
                ties += 1
                break
            compared += 1
            if not bool((gen[b, i] == want[b, i]).all()):
                raise AssertionError(f"{what}: stream {b} step {i}: token {gen[b, i].tolist()} "
                                     f"!= {want[b, i].tolist()} with top-2 gap "
                                     f"{float(gaps[b, i])} > {bound}")
    return compared, ties


def serve_one(cfg, batch_in, new, dev):
    """Phase 6's measurements and gates for one model (``cfg`` with
    ``use_pallas=True``) on one request batch; returns its results."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention, ssd_intra_chunk
    from repro_torch.launch.serve import generate, generate_eager
    from repro_torch.models import Model
    from repro_torch.utils import prng

    arch, L = cfg.name, cfg.num_layers
    kerns = path_kernels(cfg)
    batch = batch_in["tokens"].shape[0]
    per_token = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    model, plain = Model(cfg), Model(dataclasses.replace(cfg, use_pallas=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())

    # the served dtype, through the kernels: a first generate captures
    # the decode step, a second refills the allocator's cache (the
    # capture empties it) and keeps first-use costs of the library's
    # matrix products out of the timing; the third, timed, replays the
    # graph; then the eager loop on the same inputs
    before = {k: k.launches for k in (flash_attention, ssd_intra_chunk)}
    generate(model, params, batch_in, new)
    (decode_graph,) = model.decode_graphs.values()
    generate(model, params, batch_in, new)
    torch.cuda.reset_peak_memory_stats()
    gen, stats = generate(model, params, batch_in, new)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    eager_gen, eager_stats = generate_eager(model, params, batch_in, new)
    for k, n in before.items():  # one prefill in each generate
        if k.launches - n != (4 * L if k in kerns else 0):
            raise AssertionError(f"{arch}: generate launched {k.__name__} {k.launches - n} "
                                 f"times in four prefills of {L} layers")
    if len(model.decode_graphs) != 1:
        raise AssertionError(f"{arch}: one signature captured {len(model.decode_graphs)} graphs")
    if not (gen.shape == (batch, new) + per_token and int(gen.min()) >= 0
            and int(gen.max()) < cfg.vocab_size):
        raise AssertionError(f"{arch}: generated tokens of shape {tuple(gen.shape)} out of range")
    if not torch.equal(gen, eager_gen):
        raise AssertionError(f"{arch}: captured decode tokens differ from the eager loop's")
    decode_prof = profile_decode(model, params, batch_in)
    captured_prof = profile_decode_captured(model, params, batch_in, new)
    last = prefill_launches(model, params, batch_in, arch)
    plain_last = prefill_launches(plain, params, batch_in, arch)
    if not (torch.isfinite(last).all() and torch.isfinite(plain_last).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    served_gap = float((last.float() - plain_last.float()).abs().max())
    served_scale = float(plain_last.float().abs().max())

    # the gate, in float32 (the same weights, upcast in place): kernel
    # path against plain path, prefill logits and greedy tokens; a model
    # with no kernel on its path has nothing to hold
    gate = dict(f32_gate="none: no kernel on the path") if not kerns else {}
    if kerns:
        if cfg.dtype != "float32":
            params.float()
            model = Model(dataclasses.replace(cfg, dtype="float32"))
            plain = Model(dataclasses.replace(cfg, dtype="float32", use_pallas=False))
        gen32, stats32 = generate(model, params, batch_in, new)
        last32 = prefill_launches(model, params, batch_in, f"{arch} f32")
        plain32, plain_gen32, gaps = greedy_plain(plain, params, batch_in, new)
        scale = float(plain32.abs().max())
        err = float((last32 - plain32).abs().max())
        bound = F32_LOGIT_RTOL * scale
        if err > bound:
            raise AssertionError(f"{arch}: float32 prefill logits differ by {err} > {bound}")
        compared, ties = token_gate(gen32, plain_gen32, gaps, bound, f"{arch} float32")
        exact_gap = (ssd_in_f64_gap(model, params, batch_in, plain32)
                     if ssd_intra_chunk in kerns else None)
        gate = dict(f32_logits_max_abs_err=err, f32_logits_bound=bound, f32_logit_scale=scale,
                    f32_tokens_compared=compared, f32_streams_stopped_at_a_near_tie=ties,
                    f32_logits_err_with_ssd_block_in_f64=exact_gap,
                    f32_prefill_ms=stats32["prefill_s"] * 1e3)
    prefill_ms = stats["prefill_s"] * 1e3
    step_ms = stats["decode_s"] * 1e3 / max(stats["decode_steps"], 1)
    out = dict(arch=arch, params=n_params, dtype=cfg.dtype, layers=L, batch=batch,
               prompt=int(batch_in["tokens"].shape[1]),
               vision_tokens=cfg.vision_tokens if cfg.arch_type == "vlm" else 0,
               new_tokens=new, init_s=init_s, init_peak_bytes=init_peak,
               serve_peak_bytes=serve_peak, prefill_ms=prefill_ms, decode_s=stats["decode_s"],
               decode_steps=stats["decode_steps"], decode_tokens_per_s=stats["tokens_per_s"],
               decode_ms_per_step=step_ms, decode_capture_s=decode_graph.capture_s,
               eager_decode_tokens_per_s=eager_stats["tokens_per_s"],
               eager_decode_ms_per_step=eager_stats["decode_s"] * 1e3
               / max(eager_stats["decode_steps"], 1),
               eager_step_profile=decode_prof, captured_step_profile=captured_prof,
               captured_tokens_equal_eager=True,
               served_dtype_logit_gap=served_gap, served_dtype_logit_scale=served_scale,
               kernels=[k.__name__ for k in kerns], kernel_launches_per_prefill=L, **gate)
    f32_log = (dict(f32_gate=gate["f32_gate"]) if not kerns else dict(
        f32_logits_max_abs_err=gate["f32_logits_max_abs_err"],
        f32_bound=f"{gate['f32_logits_bound']:.3g}",
        f32_tokens_compared=gate["f32_tokens_compared"],
        near_ties=gate["f32_streams_stopped_at_a_near_tie"],
        f32_err_with_ssd_block_in_f64=gate["f32_logits_err_with_ssd_block_in_f64"],
        f32_prefill_ms=f"{gate['f32_prefill_ms']:.3f}"))
    log("serve", arch=arch, params=n_params, dtype=cfg.dtype, layers=L,
        init_s=f"{init_s:.3f}", init_peak_GiB=f"{init_peak / 2**30:.3f}",
        serve_peak_GiB=f"{serve_peak / 2**30:.3f}", prefill_ms=f"{prefill_ms:.3f}",
        decode_steps=stats["decode_steps"], decode_tokens_per_s=f"{stats['tokens_per_s']:.1f}",
        eager_decode_tokens_per_s=f"{eager_stats['tokens_per_s']:.1f}",
        decode_capture_s=f"{decode_graph.capture_s:.3f}",
        eager_step_kernels=decode_prof["kernels_per_step"],
        eager_step_busy_share=f"{decode_prof['busy_share']:.4f}",
        captured_step_kernels=captured_prof["kernels_per_step"],
        captured_step_kernel_ms=f"{captured_prof['kernel_ms_per_step']:.4f}",
        captured_step_busy_share=f"{captured_prof['busy_share']:.4f}",
        tokens="captured == eager", served_logit_gap=f"{served_gap}/{served_scale}",
        **f32_log,
        launches_per_prefill=",".join(f"{k.__name__}:{L}" for k in kerns) or "none")
    del params, model, plain
    torch.cuda.empty_cache()
    return out


def serve_models(dev):
    """Phase 6 for each model of ``SERVE``; returns (results, launches of
    flash_attention and ssd_intra_chunk over the phase)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, flash_attention, ssd_intra_chunk

    for k in KERNELS:  # this path's counts start here
        k.launches = 0
    res = {}
    for arch, batch, prompt, new in SERVE:
        cfg = get_config(arch, use_pallas=True)
        toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, prompt)),
                               dtype=torch.int32, device=dev)
        res[arch] = serve_one(cfg, {"tokens": toks}, new, dev)
    return res, {"flash_attention": flash_attention.launches,
                 "ssd_intra_chunk": ssd_intra_chunk.launches}


# ---------------------------------------------------------------------------
# phase 13: the moe, hybrid, audio and vlm families
# ---------------------------------------------------------------------------


def family_batch(cfg, batch, prompt, seed, dev):
    """A request batch of ``batch`` streams: ``prompt`` token ids each
    ((batch, prompt, nq) with codebooks), drawn from ``seed`` with numpy,
    and for the vlm its vision embeddings (batch, vision_tokens, 1024)."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import VISION_EMBED_DIM

    rng = np.random.default_rng(seed)
    shape = (batch, prompt) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), dtype=torch.int32,
                                     device=dev)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.vision_tokens, VISION_EMBED_DIM)),
            dtype=torch.float32, device=dev)
    return out


def family_cpu_parity(arch, dev):
    """A family's smoke config through ``generate`` on cuda (its kernels)
    and its weights, copied, on the CPU (their plain versions): prefill
    logits within ``CPU_LOGIT_TOL``, greedy tokens equal up to a near tie
    (a top-2 gap within twice that)."""
    import copy

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.utils import prng

    b, prompt, new = FAMILY_SMOKE
    cfg = get_smoke_config(arch, use_pallas=True)
    model = Model(cfg)
    params = model.init(prng.key(0), dev)
    cpu_params = copy.deepcopy(params).to("cpu")
    batch = family_batch(cfg, b, prompt, 2, dev)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    last = prefill_launches(model, params, batch, f"{cfg.name} smoke")
    gen, _ = generate(model, params, batch, new)
    cpu_last, cpu_gen, gaps = greedy_plain(model, cpu_params, cpu_batch, new)
    err = float((last.cpu() - cpu_last).abs().max())
    torch.testing.assert_close(last.cpu(), cpu_last, rtol=CPU_LOGIT_TOL, atol=CPU_LOGIT_TOL)
    compared, ties = token_gate(gen.cpu(), cpu_gen, gaps.cpu(), 2 * CPU_LOGIT_TOL,
                                f"{cfg.name} cuda vs cpu")
    return dict(arch=cfg.name, batch=b, prompt=prompt, new_tokens=new, max_abs_err=err,
                tol=CPU_LOGIT_TOL, tokens_compared=compared, near_ties=ties)


def families_phase(dev):
    """Phase 13 for each model of ``FAMILIES``, then each family's smoke
    config cuda against the CPU; returns (results, launches of
    flash_attention and ssd_intra_chunk over the phase)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, flash_attention, ssd_intra_chunk

    for k in KERNELS:  # this path's counts start here
        k.launches = 0
    res = {}
    for arch, batch, prompt, new, layers in FAMILIES:
        over = dict(use_pallas=True)
        if layers is not None:
            over["num_layers"] = layers
            log("families", arch=arch, cut=f"{layers} of {get_config(arch).num_layers} layers; "
                                           "every width uncut")
        cfg = get_config(arch, **over)
        res[arch] = serve_one(cfg, family_batch(cfg, batch, prompt, 1, dev), new, dev)
        res[arch]["published_layers"] = get_config(arch).num_layers
    res["cpu_parity"] = {}
    for arch, *_ in FAMILIES:
        r = res["cpu_parity"][arch] = family_cpu_parity(arch, dev)
        log("families", smoke=r["arch"], cuda_vs_cpu_logits=f"{r['max_abs_err']}<={r['tol']}",
            tokens_compared=r["tokens_compared"], near_ties=r["near_ties"])
    return res, {"flash_attention": flash_attention.launches,
                 "ssd_intra_chunk": ssd_intra_chunk.launches}


# ---------------------------------------------------------------------------
# phase 14: training every family (launch/train.py)
# ---------------------------------------------------------------------------


def train_run(arch, dev, *, layers, batch, seq, steps, microbatches, warmup, donate,
              capture=False, data_vocab=None):
    """Phase 14 (a) / (b): ``make_train_step`` with AdamW
    (``cosine_schedule(3e-4, warmup, steps)``) on ``arch`` at its
    published width (``layers`` None: its depth too), ``adjust_config``
    for ``train_4k`` (remat on), bf16 weights from ``Model.init`` (seed
    0), batches from ``make_markov_task`` (over ``data_vocab`` tokens, the
    model's vocabulary unless given) drawn before the run. The first
    microbatch's loss with remat on against off, bitwise; then ``steps``
    steps, the last under torch.profiler. Eager steps are timed one by
    one; with ``capture`` (and ``donate``: the state stays at its
    addresses) the first ``TRAIN_EAGER_STEPS`` run eagerly, the step is
    then captured as a CUDA graph and replayed for the rest (its first
    replay held to an eager step from a copy of the state: the loss
    bitwise)."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, adjust_config
    from repro_torch.data import make_markov_task, sample_batch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_replace

    over = {} if layers is None else dict(num_layers=layers)
    cfg = adjust_config(get_config(arch, **over), SHAPES["train_4k"])
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model.params_tree(model.init(prng.key(0, device=dev), dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    t0 = time.perf_counter()
    task = make_markov_task(data_vocab or cfg.vocab_size, device=dev)
    key = prng.key(1, device=dev)
    data = [sample_batch(task, prng.fold_in(key, i), batch, seq) for i in range(steps)]
    del task
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    # the first microbatch's loss and gradients with remat on and off
    t0 = time.perf_counter()
    first = {k: v[:batch // microbatches] for k, v in data[0].items()}
    remat = {}
    for on in (True, False):
        m = Model(dataclasses.replace(cfg, remat=on))
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        loss, _ = m.loss(tree_replace(params, leaves), first)
        grads = torch.autograd.grad(loss, leaves)
        remat[on] = (loss.detach(), grads)
        del leaves, loss
    if not torch.equal(remat[True][0], remat[False][0]):
        raise AssertionError(f"{arch}: the loss with remat {float(remat[True][0])} is not "
                             f"bitwise the loss without {float(remat[False][0])}")
    remat_grad_err = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(remat[True][1], remat[False][1]))
    remat_loss = float(remat[True][0])
    del remat, grads
    remat_s = time.perf_counter() - t0

    opt = adamw(cosine_schedule(3e-4, warmup=warmup, total=steps))
    opt_state = opt.init(params)
    step = make_train_step(model, opt, microbatches=microbatches, donate=donate)
    batch_buf = {k: v.clone() for k, v in data[0].items()}  # the step's input, at one address

    def feed(i):
        for k, v in batch_buf.items():
            v.copy_(data[i][k])

    def record(met):
        losses.append(met["loss"].clone())
        auxes.append(met["aux"].clone())

    # eager steps: all but the last without a capture; with one, its
    # warm-up, on a side stream (torch.cuda.graph's recipe)
    losses, auxes, eager_ms = [], [], []
    n_eager = TRAIN_EAGER_STEPS if capture else steps - 1
    stream = torch.cuda.Stream() if capture else torch.cuda.current_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(n_eager):
            feed(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = step(params, opt_state, batch_buf)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            record(met)
    torch.cuda.current_stream().wait_stream(stream)
    eager_ms_step = sum(eager_ms[1:]) / len(eager_ms[1:])  # the first warms the allocator
    capture_s = captured_vs_eager = None
    if capture:
        # the donated step updates params and opt_state in place, so each
        # replay is the next step
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            _, _, met = step(params, opt_state, batch_buf)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        # the captured step against an eager step from a copy of the same state
        feed(n_eager)
        state = (params, opt_state)
        copy = tree_replace(state, [x.clone() for x in tree_leaves(state)])
        _, _, e_met = step(*copy, batch_buf)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(e_met["loss"], met["loss"]):
            raise AssertionError(f"{arch}: the captured step's loss {float(met['loss'])} is not "
                                 f"the eager step's {float(e_met['loss'])}")
        captured_vs_eager = dict(loss="bitwise", param_max_abs_diff=max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(copy[0]), tree_leaves(params))))
        del copy, e_met
        record(met)
        t1 = time.perf_counter()
        for i in range(n_eager + 1, steps - 1):
            feed(i)
            graph.replay()
            record(met)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t1) * 1e3 / (steps - 2 - n_eager)
    else:
        ms_step = eager_ms_step
    t0 = time.perf_counter()
    feed(steps - 1)  # the last step under the profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device's kernels only
        p0 = time.perf_counter()
        if capture:
            graph.replay()
        else:
            params, opt_state, met = step(params, opt_state, batch_buf)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - p0) * 1e6
    record(met)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    auxes = [float(x) for x in auxes]
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler saw no device kernel")
    prof_res = _busy(events, wall_us, 1)
    profile_s = time.perf_counter() - t0
    head, tail = losses[:5], losses[-5:]
    if not all(map(math.isfinite, losses + auxes)):
        raise AssertionError(f"{arch}: a loss is not finite: {losses}")
    if not sum(tail) / len(tail) < sum(head) / len(head):
        raise AssertionError(f"{arch}: the loss did not fall: {head} -> {tail}")
    tokens = batch * seq
    del params, opt_state, data, batch_buf, met
    if capture:
        del graph
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.num_layers,
                published_layers=get_config(arch).num_layers, params=n_params,
                batch=batch, seq=seq, steps=steps, microbatches=microbatches, remat=cfg.remat,
                donate=donate, data_vocab=data_vocab or cfg.vocab_size, init_s=init_s,
                data_s=data_s, ms_per_step=ms_step, captured=capture, capture_s=capture_s,
                eager_ms_per_step=eager_ms_step, eager_step_ms=eager_ms,
                captured_vs_eager=captured_vs_eager,
                tokens_per_s=tokens * 1e3 / ms_step, peak_memory_gib=peak / 2**30,
                resident_before_gib=base / 2**30, remat_s=remat_s, profile_s=profile_s,
                first_losses=head, last_losses=tail, aux=auxes if cfg.arch_type == "moe" else None,
                remat_first_loss=remat_loss, remat_loss_bitwise=True,
                remat_grad_max_abs_diff=remat_grad_err, profile=prof_res)


class RoutingLog:
    """Records the router's decisions (``moe.moe_routing``'s expert ids,
    slots and probabilities) of every MoE layer call while active."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._orig = [], moe.moe_routing

        def record(params, xf, cfg, C):
            out = self._orig(params, xf, cfg, C)
            self.calls.append(tuple(t.detach().cpu() for t in out[1:]))
            return out

        moe.moe_routing = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_routing = self._orig


def same_routing(got, want, k, what, margin=1e-6):
    """Routing on two devices: expert ids equal for every token whose k-th
    and (k+1)-th router probabilities differ by more than ``margin``
    (nearer ties may fall either way), slots equal in each group without
    such a tie. Returns the near ties."""
    import torch

    ties = 0
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} router calls against {len(want)}")
    for (ids, slot, probs), (w_ids, w_slot, w_probs) in zip(got, want):
        top = torch.topk(w_probs, min(k + 1, w_probs.shape[-1]), dim=-1).values
        clear = (top[..., k - 1] - top[..., k] > margin) if top.shape[-1] > k else \
            torch.ones(top.shape[:-1], dtype=torch.bool)
        ties += int((~clear).sum())
        if not torch.equal(ids[clear], w_ids[clear]):
            raise AssertionError(f"{what}: expert ids differ away from a near tie")
        groups = clear.all(dim=-1)
        if not torch.equal(slot[groups], w_slot[groups]):
            raise AssertionError(f"{what}: slots differ in a group without a near tie")
    return ties


def train_cpu_parity(arch, dev):
    """Phase 14 (c): one ``make_train_step`` (SGD 0.1) of a family's
    smoke config in float32 from the same weights (``Model.init`` seed 0
    on the CPU, copied to the card) and a numpy-seeded batch, on cuda and
    on the CPU: loss within ``TRAIN_LOSS_RTOL`` relative, every updated
    parameter within ``TRAIN_PARAM_TOL`` (rtol, atol), MoE routing as
    :func:`same_routing` holds it."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import sgd
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_map

    b, s = TRAIN_SMOKE
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    cpu_params = Model.params_tree(model.init(prng.key(0), "cpu"))
    batch = family_batch(cfg, b, s - (cfg.vision_tokens if cfg.arch_type == "vlm" else 0), 3,
                         "cpu")
    rng = np.random.default_rng(4)
    batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, batch["tokens"].shape),
                                      dtype=torch.int32)
    runs = {}
    for where in ("cuda", "cpu"):
        params = tree_map(lambda x: x.to(dev if where == "cuda" else "cpu"), cpu_params)
        data = {k: v.to(params["embed"].device) for k, v in batch.items()}
        with RoutingLog() as log_:
            new, _, met = make_train_step(model, sgd(0.1))(params, sgd(0.1).init(params), data)
        runs[where] = ([x.cpu() for x in tree_leaves(new)],
                       {k: float(v) for k, v in met.items()}, log_.calls)
    (got, gmet, groute), (want, wmet, wroute) = runs["cuda"], runs["cpu"]
    loss_err = abs(gmet["loss"] - wmet["loss"]) / abs(wmet["loss"])
    if loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{cfg.name}: loss {gmet['loss']} on cuda, {wmet['loss']} on the CPU")
    rtol, atol = TRAIN_PARAM_TOL
    err = 0.0
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol)
        err = max(err, float((a - w).abs().max()))
    ties = same_routing(groute, wroute, cfg.moe_top_k, cfg.name) if cfg.arch_type == "moe" else None
    return dict(arch=cfg.name, batch=b, seq=s, loss=wmet["loss"], aux=wmet["aux"],
                loss_rel_err=loss_err, param_max_abs_err=err, tol=dict(
                    loss_rtol=TRAIN_LOSS_RTOL, rtol=rtol, atol=atol),
                router_calls=len(wroute) if ties is not None else None, near_ties=ties)


def train_phase(dev):
    """Phase 14: (a) hymba-1.5b whole, (b) dbrx-132b at one layer, (c)
    each family's smoke config cuda against the CPU. Training runs
    ``use_pallas=False`` (no model kernel has a backward), so no kernel of
    the port may launch here."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS

    gc.collect()
    torch.cuda.empty_cache()
    log("train", resident_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    before = {k.__name__: k.launches for k in KERNELS}
    res = {}
    for label, kw in TRAIN_RUNS:
        arch = kw["arch"]
        if kw["layers"] is not None:
            log("train", arch=arch, cut=f"{kw['layers']} of {get_config(arch).num_layers} layers; "
                                        "every width uncut")
        r = res[label] = train_run(dev=dev, **kw)
        log("train", run=label, arch=r["arch"], params=r["params"], layers=r["layers"],
            batch=f"{r['batch']}x{r['seq']}", microbatches=r["microbatches"],
            init_s=f"{r['init_s']:.2f}", data_s=f"{r['data_s']:.2f}",
            ms_per_step=f"{r['ms_per_step']:.1f}", captured=r["captured"],
            eager_ms_per_step=f"{r['eager_ms_per_step']:.1f}", capture_s=r["capture_s"],
            captured_vs_eager=r["captured_vs_eager"], tokens_per_s=f"{r['tokens_per_s']:.0f}",
            peak_gib=f"{r['peak_memory_gib']:.2f}", before_gib=f"{r['resident_before_gib']:.2f}",
            remat_s=f"{r['remat_s']:.1f}", profile_s=f"{r['profile_s']:.1f}",
            kernels_per_step=f"{r['profile']['kernels_per_step']:.0f}",
            busy=f"{r['profile']['busy_share']:.3f}", first_losses=r["first_losses"],
            last_losses=r["last_losses"], aux=r["aux"],
            remat="first loss bitwise remat off", remat_grad_diff=r["remat_grad_max_abs_diff"])
    res["cpu_parity"] = {}
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        r = res["cpu_parity"][arch] = train_cpu_parity(arch, dev)
        r["s"] = time.perf_counter() - t0
        log("train", smoke=r["arch"], s=f"{r['s']:.1f}",
            loss_rel_err=f"{r['loss_rel_err']:.2e}<={TRAIN_LOSS_RTOL}",
            param_max_abs_err=f"{r['param_max_abs_err']:.2e}", near_ties=r["near_ties"])
    grew = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    if any(grew.values()):
        raise AssertionError(f"training launched a model kernel: {grew}")
    gc.collect()
    torch.cuda.empty_cache()
    log("train", resident_after_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    return res


# ---------------------------------------------------------------------------
# phases 3-5: the port's entry points
# ---------------------------------------------------------------------------


def experiment(graph, alg, steps, device, *, protocol_start, failures, **pkw):
    from repro_torch.api import Experiment
    from repro_torch.core import FailureConfig, ProtocolConfig

    pcfg = ProtocolConfig(
        algorithm=alg, z0=PAPER["z0"], max_walks=PAPER["max_walks"],
        rt_bins=PAPER["rt_bins"], protocol_start=protocol_start, **ALGS.get(alg, {}), **pkw,
    )
    return Experiment(graph=graph, protocol=pcfg, failures=FailureConfig(**failures),
                      steps=steps, outputs="full", device=device)


def main_experiment(graph, alg, steps):
    """The paper's configuration of Figs. 1-3 on the card."""
    return experiment(graph, alg, steps, "cuda", protocol_start=PAPER["protocol_start"],
                      failures=dict(burst_times=PAPER["bursts"],
                                    burst_sizes=PAPER["burst_sizes"]),
                      estimator_impl="auto", round_impl="auto")


def new_runner(slots):
    """The runner the last call added to the Plan's executable cache
    (``slots``: the cache's keys before that call)."""
    from repro_torch.api import plan as plan_mod

    (runner,) = [r for k, r in plan_mod._EXECUTABLES.items() if k not in slots]
    return runner


def graph_launches(runner, what, per_round):
    """The captured round's launches of each kernel, read from the graph's
    kernel nodes (``Captured.per_replay``), must be ``per_round`` (kernel
    name -> launches in one round)."""
    got = {k.__name__: n for k, n in runner.graph.per_replay.items()}
    if got != per_round:
        raise AssertionError(f"{what}: the captured round holds {got}, expected {per_round}")


def device_launches(fn):
    """Kernel name -> launches of that kernel the device recorded
    (torch.profiler's CUDA events, graph nodes included) while ``fn``
    ran; and all the CUDA events."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler saw no device kernel (graph nodes not attributed)")
    counts = {}
    for k in KERNELS:
        pat = re.compile("|".join(rf"\b{s}\b" for s in k.symbols))
        counts[k.__name__] = sum(e.count for e in events if pat.search(e.key))
    return counts, events, wall_us


def gated_device_launches(fn, want, what, tries=3):
    """:func:`device_launches` of ``fn``, held to ``want`` (kernel name ->
    launches): the wrappers' counters must grow by exactly ``want`` in
    every window, and the profiler must count ``want``. The profiler
    can drop activity records under load (CUPTI's buffers), and a
    dropped record is a launch it did not see, so a window whose count
    falls short repeats, up to ``tries`` windows; the short windows'
    counts are returned beside the result."""
    from repro_torch.kernels import KERNELS

    short = []
    for _ in range(tries):
        before = {k.__name__: k.launches for k in KERNELS}
        seen, events, wall_us = device_launches(fn)
        grew = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
        if grew != want:
            raise AssertionError(f"{what}: the counters grew by {grew}, expected {want}")
        if seen == want:
            return seen, events, wall_us, short
        short.append({k: v for k, v in seen.items() if v != want[k]})
    raise AssertionError(f"{what}: the device launched {short} in {tries} windows, "
                         f"expected {want}")


def main_path(graph, steps, seeds, kernel_device_ms):
    """Phase 3: the ensembles through ``Experiment.ensemble``, each round a
    replay of one captured round (its capture timed apart). whole_round's
    launches: one in the capture's warm-up round, then one per replayed
    round (the captured graph's whole_round nodes, once per replay)."""
    import numpy as np
    import torch

    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import whole_round

    res = {}
    for alg in ALGS:
        exp = main_experiment(graph, alg, steps)
        (_, _, decision), = exp.plan().round_decisions()
        if not decision.fused:
            raise AssertionError(f"the main path did not fuse: {decision.reason}")
        slots = set(plan_mod._EXECUTABLES)
        torch.cuda.synchronize()
        before = whole_round.launches
        t0 = time.perf_counter()
        outs = exp.ensemble(seeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runner = new_runner(slots)
        if runner.captures != 1:
            raise AssertionError(f"{alg}: the ensemble's rounds were not one captured graph")
        graph_launches(runner, alg, {"whole_round": 1})
        launches = whole_round.launches - before
        if launches != steps + 1:
            raise AssertionError(f"whole_round launched {launches} times for {steps} rounds "
                                 "and the capture's warm-up round")
        z = outs.z.cpu().numpy()
        if z.shape != (seeds, steps):
            raise AssertionError(f"z has shape {z.shape}")
        start = min(PAPER["protocol_start"], steps - 1)
        post = z[:, start:]
        alive = float((z > 0).all(axis=1).mean())
        mean_z = float(post.mean())
        if alive < 1.0 or not PAPER["z0"] / 2 <= mean_z <= 2 * PAPER["z0"]:
            raise AssertionError(f"{alg}: survival {alive}, mean Z after start {mean_z}")
        if not np.isfinite(outs.theta_mean.cpu().numpy()).all():
            raise AssertionError(f"{alg}: non-finite theta_mean")
        replay_s = wall - runner.capture_s
        ms_round = replay_s * 1e3 / steps
        share = steps * kernel_device_ms / (replay_s * 1e3)
        res[alg] = dict(steps=steps, seeds=seeds, wall_s=wall, capture_s=runner.capture_s,
                        ms_per_round=ms_round,
                        trajectory_rounds_per_s=seeds * steps / replay_s,
                        whole_round_share=share, survival=alive, mean_z_after_start=mean_z,
                        max_z=int(z.max()), min_z_after_start=int(post.min()),
                        forks=int(outs.forks.sum()), terms=int(outs.terms.sum()),
                        whole_round_launches=launches, graph_kernel_nodes=runner.graph.kernel_nodes,
                        head=outs.map(lambda v: v[:, :EAGER_WINDOW]))
        if alg == "decafork":
            res[alg]["outs"] = outs  # phase 11 resumes this run
        log("main", alg=alg, steps=steps, seeds=seeds, wall_s=f"{wall:.3f}",
            capture_s=f"{runner.capture_s:.3f}", captured_ms_per_round=f"{ms_round:.4f}",
            trajectory_rounds_per_s=f"{seeds * steps / replay_s:.1f}",
            whole_round_share=f"{share:.4f}", survival=alive, mean_z=f"{mean_z:.3f}",
            whole_round_launches=f"{launches}(1 warm-up + {steps} replays x 1 graph node)",
            graph_kernel_nodes=runner.graph.kernel_nodes)
    return res


def eager_window(label, setup, keys, spec, decision, head, rounds=None):
    """The same run's first ``rounds`` rounds through the eager loop
    (``run_rounds``): their ms per round, and their outputs against the
    captured run's (``head``), integers and theta_mean bitwise."""
    import torch

    from repro_torch.core import simulator as sim

    rounds = rounds or head.z.shape[-1]
    state = sim.init_state(keys, setup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _final, rec = sim.run_rounds(state, setup, rounds, spec, decision)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / rounds
    for f in rec._fields:
        got, want = getattr(rec, f).cpu(), getattr(head, f).reshape(getattr(rec, f).shape).cpu()
        if got.dtype.is_floating_point:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the eager loop's {f} differs from the captured run's")
    return ms


def main_eager_windows(graph, seeds, main_res):
    """Phase 3's eager ms per round over the first EAGER_WINDOW rounds of
    each ensemble, from the same keys, held to its captured run."""
    from repro_torch.utils import prng

    for alg, r in main_res.items():
        plan = main_experiment(graph, alg, r["steps"]).plan()
        keys = prng.split(prng.key(0, device="cuda"), seeds)
        ms = eager_window(f"phase 3 {alg}", plan._setup(seeds), keys, plan.spec,
                          plan.decision, r.pop("head"))
        r.update(eager_ms_per_round=ms, captured_speedup=ms / r["ms_per_round"])
        log("main", alg=alg, eager_rounds=EAGER_WINDOW, eager_ms_per_round=f"{ms:.4f}",
            captured_ms_per_round=f"{r['ms_per_round']:.4f}",
            captured_speedup=f"{ms / r['ms_per_round']:.2f}",
            outputs="eager window bitwise the captured run")


def profile_rounds(graph, seeds, rounds=PROFILE_ROUNDS):
    """The captured round under torch.profiler: ``rounds`` replays of the
    main path's round after its capture. The device's whole_round
    launches must equal the replayed rounds and the wrapper counter's
    growth (:func:`gated_device_launches`). Busy share: the CUDA kernels' device time over the profiled
    wall time (all kernels, and whole_round alone); kernels per round
    from the same events, beside the graph's kernel nodes. Beside it,
    CUDA events around the same replays without the profiler give the
    device's ms per round."""
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import SCALARS
    from repro_torch.kernels import KERNELS
    from repro_torch.utils import prng

    res = {}
    for alg in ALGS:
        plan = main_experiment(graph, alg, rounds).plan()
        keys = prng.split(prng.key(0, device="cuda"), seeds)
        setup = plan._setup(seeds)
        runner = sim.RoundRunner(setup, SCALARS, plan.decision)
        state = sim.init_state(keys, setup)
        runner.run(state, setup)  # captures
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        runner.run(state, setup)
        b.record()
        b.synchronize()
        event_ms = a.elapsed_time(b) / rounds
        want = {k.__name__: rounds if k.__name__ == "whole_round" else 0 for k in KERNELS}
        seen, events, wall_us, short = gated_device_launches(
            lambda: runner.run(state, setup), want, alg)
        busy = sum(e.self_device_time_total for e in events)
        wr = sum(e.self_device_time_total for e in events if "whole_round" in e.key)
        launches = sum(e.count for e in events)
        out = dict(rounds=rounds, captured=True, event_ms_per_round=event_ms,
                   profiled_wall_ms_per_round=wall_us / rounds / 1e3,
                   device_busy_share=busy / wall_us, whole_round_share=wr / wall_us,
                   device_kernels_per_round=launches / rounds,
                   graph_kernel_nodes=runner.graph.kernel_nodes,
                   device_kernel_ms_per_round=busy / rounds / 1e3,
                   whole_round_device_launches=seen["whole_round"],
                   short_windows=short)
        log("profile", alg=alg, **out)
        res[alg] = out
    return res


def phase5_device_launches(graph):
    """Phase 5's captured unfused rounds under torch.profiler (8 rounds
    each, 50 seeds): the device's launches of each kernel must equal one
    per round of the path's kernel (round_update for
    ``estimator_impl="fused"``, theta_sums for ``"pallas"`` and
    ``auto_eps``, none for MissingPerson) and the counters' growth
    (:func:`gated_device_launches`)."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import SCALARS
    from repro_torch.kernels import KERNELS
    from repro_torch.utils import prng

    rounds, seeds = 8, PAPER["seeds"]
    fail = dict(burst_times=(100, 150), burst_sizes=PAPER["burst_sizes"])
    cases = (
        ("unfused fused-estimator", "decafork", dict(estimator_impl="fused"), "round_update"),
        ("unfused pallas", "decafork", dict(estimator_impl="pallas"), "theta_sums"),
        ("auto_eps", "decafork+", dict(auto_eps=True, estimator_impl="pallas",
                                      auto_min_samples=5), "theta_sums"),
        ("missingperson", "missingperson", dict(eps_mp=50.0), None),
    )
    res = {}
    for label, alg, kw, kern in cases:
        plan = experiment(graph, alg, rounds, "cuda", protocol_start=2, failures=fail,
                          round_impl="unfused", **kw).plan()
        if plan.decision.fused:
            raise AssertionError(f"{label} took the fused round")
        setup = plan._setup(seeds)
        state = sim.init_state(prng.split(prng.key(0, device="cuda"), seeds), setup)
        runner = sim.RoundRunner(setup, SCALARS, plan.decision)
        runner.run(state, setup)  # captures
        graph_launches(runner, label, {kern: 1} if kern else {})
        want = {k.__name__: rounds if k.__name__ == kern else 0 for k in KERNELS}
        seen, events, _, short = gated_device_launches(
            lambda: runner.run(state, setup), want, label)
        res[label] = dict(rounds=rounds, seeds=seeds, device_launches=seen, short_windows=short,
                          graph_kernel_nodes=runner.graph.kernel_nodes,
                          device_kernels_per_round=sum(e.count for e in events) / rounds)
        log("unfused", device_launches=label, rounds=rounds, seeds=seeds,
            **{k: v for k, v in seen.items() if v}, counters="equal", short_windows=short,
            graph_kernel_nodes=runner.graph.kernel_nodes)
    return res


def int_outputs_equal(a, b, label):
    import numpy as np

    for f in INT_FIELDS:
        if not np.array_equal(getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy()):
            raise AssertionError(f"{label}: {f} differs")


def cross_device(graph):
    import numpy as np

    steps, seeds = 160, 4  # every CHURN event (the last at step 140) has fired
    res = {}
    for alg in ALGS:
        outs = [
            experiment(graph, alg, steps, dev, protocol_start=50, failures=CHURN,
                       estimator_impl="auto").ensemble(seeds)
            for dev in ("cuda", "cpu")
        ]
        int_outputs_equal(outs[0], outs[1], f"cross-device {alg}")
        err = float(np.abs(outs[0].theta_mean.cpu().numpy() - outs[1].theta_mean.numpy()).max())
        np.testing.assert_allclose(outs[0].theta_mean.cpu().numpy(), outs[1].theta_mean.numpy(),
                                   rtol=1e-6, atol=1e-6)
        res[alg] = dict(steps=steps, seeds=seeds, theta_mean_max_abs_err=err,
                        forks=int(outs[1].forks.sum()), terms=int(outs[1].terms.sum()))
        log("parity", alg=alg, steps=steps, seeds=seeds, integers="bitwise",
            theta_mean_max_abs_err=err)
    return res


def unfused_paths(graph, counts):
    import torch

    from repro_torch.api import cache_stats
    from repro_torch.kernels import round_update, theta_sums

    steps, seeds = 160, PAPER["seeds"]  # both bursts (100, 150) fire
    fail = dict(burst_times=(100, 150), burst_sizes=PAPER["burst_sizes"])
    res = {}
    for alg in ALGS:
        kw = dict(protocol_start=50, failures=fail)
        fused = experiment(graph, alg, steps, "cuda", estimator_impl="fused", **kw).ensemble(seeds)
        for eimpl, kern in (("fused", round_update), ("pallas", theta_sums)):
            torch.cuda.synchronize()
            kern.launches = 0
            captured = cache_stats()["graphs_captured"]
            t0 = time.perf_counter()
            outs = experiment(graph, alg, steps, "cuda", estimator_impl=eimpl,
                              round_impl="unfused", **kw).ensemble(seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # one launch per round, and one in each new capture's warm-up round
            want = steps + cache_stats()["graphs_captured"] - captured
            if kern.launches != want:
                raise AssertionError(f"{kern.__name__} launched {kern.launches} times, "
                                     f"expected {want}")
            counts[kern.__name__] += kern.launches
            int_outputs_equal(outs, fused, f"unfused {eimpl} {alg}")
            res[f"{alg}/{eimpl}"] = dict(steps=steps, seeds=seeds, wall_s=wall,
                                         ms_per_round=wall * 1e3 / steps)
            log("unfused", alg=alg, estimator_impl=eimpl, steps=steps, seeds=seeds,
                launches=kern.launches, ms_per_round=f"{wall * 1e3 / steps:.4f}",
                integers="equal to the fused round")
    return res


def estimator_modes(graph, counts):
    """Phase 5's other estimator modes, on cuda against the CPU: auto_eps
    through the theta_sums kernel (one launch per round) and the analytic
    survival of footnote 5 (unfused, no kernel); integer outputs bitwise,
    theta_mean within 1e-6."""
    import numpy as np
    import torch

    from repro_torch.api import cache_stats
    from repro_torch.kernels import KERNELS, theta_sums

    steps, seeds = 200, 4
    fail = dict(burst_times=(150,), burst_sizes=PAPER["burst_sizes"][:1])
    res = {}
    for label, kw, kern in (
        ("auto_eps", dict(auto_eps=True, estimator_impl="pallas", auto_min_samples=5), theta_sums),
        ("analytic_survival", dict(analytic_survival=True), None),
    ):
        outs, walls = {}, {}
        for dev in ("cuda", "cpu"):
            exp = experiment(graph, "decafork+", steps, dev, protocol_start=100, failures=fail,
                             **kw)
            (_, _, decision), = exp.plan().round_decisions()
            if decision.fused:
                raise AssertionError(f"{label} took the fused round")
            for k in KERNELS:
                k.launches = 0
            captured = cache_stats()["graphs_captured"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[dev] = exp.ensemble(seeds)
            torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
            if dev == "cuda":
                launched = {k.__name__: k.launches for k in KERNELS if k.launches}
                warmups = cache_stats()["graphs_captured"] - captured
        # one launch per round, and one in each new capture's warm-up round
        want = {kern.__name__: steps + warmups} if kern is not None else {}
        if launched != want:
            raise AssertionError(f"{label}: kernel launches {launched}, expected {want}")
        for name, n in launched.items():
            counts[name] += n
        int_outputs_equal(outs["cuda"], outs["cpu"], f"{label} cuda vs cpu")
        theta = outs["cuda"].theta_mean.cpu().numpy()
        err = float(np.abs(theta - outs["cpu"].theta_mean.numpy()).max())
        np.testing.assert_allclose(theta, outs["cpu"].theta_mean.numpy(), rtol=1e-6, atol=1e-6)
        res[label] = dict(steps=steps, seeds=seeds, launches=launched,
                          ms_per_round=walls["cuda"] * 1e3 / steps, theta_mean_max_abs_err=err,
                          forks=int(outs["cpu"].forks.sum()), terms=int(outs["cpu"].terms.sum()))
        log("unfused", mode=label, alg="decafork+", steps=steps, seeds=seeds, launches=launched,
            ms_per_round=f"{walls['cuda'] * 1e3 / steps:.4f}", integers="bitwise cuda vs cpu",
            theta_mean_max_abs_err=err, forks=res[label]["forks"], terms=res[label]["terms"])
    return res


def captured_vs_eager(graph):
    """At full width for 150 steps, with decisions from step 50 under the
    CHURN failures: a captured run (``RoundRunner``) equals the eager loop
    (``run_rounds``) bitwise in its integer outputs, its final carry and
    theta_mean, for a fused group (DecAFork+), MissingPerson and
    auto_eps (theta_sums)."""
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    steps, seeds = 150, PAPER["seeds"]  # every CHURN event (the last at 140) fires
    kw = dict(protocol_start=50, failures=CHURN)
    res = {}
    for label, exp in (
        ("fused", experiment(graph, "decafork+", steps, "cuda", estimator_impl="auto", **kw)),
        ("missingperson", experiment(graph, "missingperson", steps, "cuda", eps_mp=50.0, **kw)),
        ("auto_eps", experiment(graph, "decafork+", steps, "cuda", auto_eps=True,
                                estimator_impl="pallas", auto_min_samples=5, **kw)),
    ):
        plan = exp.plan()
        alg = plan.pcfg.algorithm
        setup = plan._setup(seeds)
        keys = prng.split(prng.key(3, device="cuda"), seeds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = sim.run_rounds(sim.init_state(keys, setup), setup, steps, FULL, plan.decision)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        runner = sim.RoundRunner(setup, FULL, plan.decision)
        runner.run(sim.init_state(keys, setup), setup)  # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = runner.run(sim.init_state(keys, setup), setup)
        torch.cuda.synchronize()
        captured_s = time.perf_counter() - t0
        for part, g, w in (("final carry", got[0], want[0]),
                           ("outputs", tuple(got[1]), tuple(want[1]))):
            g, w = tree_leaves(g), tree_leaves(w)
            if len(g) != len(w) or not g:
                raise AssertionError(f"captured {label}: {part} has another structure")
            for x, y in zip(g, w):
                x, y = x.cpu(), y.cpu()
                if x.dtype.is_floating_point:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                if not torch.equal(x, y):
                    raise AssertionError(f"captured {label}: {part} differs from the eager loop")
        forks = int(want[1].forks.sum())
        if forks == 0:
            raise AssertionError(f"captured {label}: no rule fired")
        res[label] = dict(steps=steps, seeds=seeds, algorithm=alg, fused=plan.decision.fused,
                          eager_ms_per_round=eager_s * 1e3 / steps,
                          captured_ms_per_round=captured_s * 1e3 / steps,
                          capture_s=runner.capture_s, forks=forks)
        log("captured", case=label, alg=alg, steps=steps, seeds=seeds,
            eager_ms_per_round=f"{eager_s * 1e3 / steps:.4f}",
            captured_ms_per_round=f"{captured_s * 1e3 / steps:.4f}",
            capture_s=f"{runner.capture_s:.3f}", forks=forks,
            integers_final_carry_theta_mean="bitwise the eager loop")
    return res


# ---------------------------------------------------------------------------
# phase 7: the paper's figure sweeps
# ---------------------------------------------------------------------------


def figure_scenarios(protocol_start, failures, eps_mp):
    """Fig. 5's DecAFork eps grid (2.0 is Fig. 1's DecAFork curve), then
    Fig. 1's DecAFork+ and MissingPerson curves: three groups."""
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.sweep import Scenario

    fail = FailureConfig(**failures)
    common = dict(z0=PAPER["z0"], max_walks=PAPER["max_walks"], rt_bins=PAPER["rt_bins"],
                  protocol_start=protocol_start, estimator_impl="auto", round_impl="auto")
    scen = [Scenario(f"decafork eps={e}", ProtocolConfig(algorithm="decafork", eps=e, **common),
                     fail) for e in EPS_GRID]
    scen.append(Scenario("decafork+", ProtocolConfig(algorithm="decafork+", **ALGS["decafork+"],
                                                     **common), fail))
    scen.append(Scenario("missingperson", ProtocolConfig(algorithm="missingperson", eps_mp=eps_mp,
                                                         **common), fail))
    return scen


def sweep_phase(graph, steps, seeds, phase3):
    """Phase 7: Figs. 1 and 5 as one sweep on cuda, timed per group; each
    group is one round loop over its scenarios x seeds rows."""
    import numpy as np
    import torch

    from repro_torch.api import Experiment
    from repro_torch.api import plan as plan_mod
    from repro_torch.core import simulator as sim
    from repro_torch.kernels import KERNELS, whole_round
    from repro_torch.utils import prng

    fail = dict(burst_times=PAPER["bursts"], burst_sizes=PAPER["burst_sizes"])
    scen = figure_scenarios(PAPER["protocol_start"], fail, EPS_MP)
    plan = Experiment(graph=graph, scenarios=scen, steps=steps, device="cuda").plan()
    decisions = []
    for _sig, idxs, d in plan.round_decisions():
        alg = scen[idxs[0]].pcfg.algorithm
        mp = alg == "missingperson"
        if d.fused == mp or (mp and d.reason != "algorithm 'missingperson' has no fused round"):
            raise AssertionError(f"group {idxs} ({alg}): {d}")
        decisions.append(dict(scenarios=[scen[i].name for i in idxs], impl=d.impl, reason=d.reason))
    groups, runners = [], []
    stacked = plan.sweep_stacked

    def timed(scenarios, **kw):  # each group's wall time, capture and launches
        slots = set(plan_mod._EXECUTABLES)
        torch.cuda.synchronize()
        before = whole_round.launches
        t0 = time.perf_counter()
        out = stacked(scenarios, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runner = new_runner(slots)
        if runner.captures != 1:
            raise AssertionError(f"group {[s.name for s in scenarios]}: not one captured graph")
        fused = scenarios[0].pcfg.algorithm != "missingperson"
        graph_launches(runner, scenarios[0].name, {"whole_round": 1} if fused else {})
        runners.append((runner, out.map(lambda v: v[:, :, :EAGER_WINDOW])))
        replay_s = wall - runner.capture_s
        rows = len(scenarios) * seeds
        groups.append(dict(scenarios=[s.name for s in scenarios],
                           algorithm=scenarios[0].pcfg.algorithm, rows=rows, steps=steps,
                           wall_s=wall, capture_s=runner.capture_s,
                           ms_per_round=replay_s * 1e3 / steps,
                           trajectory_rounds_per_s=rows * steps / replay_s,
                           whole_round_launches=whole_round.launches - before,
                           graph_kernel_nodes=runner.graph.kernel_nodes))
        return out

    plan.sweep_stacked = timed
    for k in KERNELS:  # this path's counts start here
        k.launches = 0
    res = plan.sweep(seeds=seeds)
    counts = {k.__name__: k.launches for k in KERNELS}
    base = phase3["decafork"]["trajectory_rounds_per_s"]
    keys = prng.split(prng.key(0, device="cuda"), seeds)
    for g, (runner, head) in zip(groups, runners):
        # one per round and one in the capture's warm-up round
        want = 0 if g["algorithm"] == "missingperson" else steps + 1
        if g["whole_round_launches"] != want:
            raise AssertionError(f"group {g['scenarios']}: whole_round launched "
                                 f"{g['whole_round_launches']} times, expected {want}")
        g["vs_phase3_decafork"] = g["trajectory_rounds_per_s"] / base
        # the group's first rounds through the eager loop, from the same
        # rows (the runner's static setup holds the group's values)
        S = len(g["scenarios"])
        eager = eager_window(f"phase 7 {g['scenarios']}", runner.setup, keys.repeat(S, 1),
                             runner.spec, runner.decision, head)
        g.update(eager_ms_per_round=eager, captured_speedup=eager / g["ms_per_round"])
        log("sweep", group=repr(",".join(g["scenarios"])), rows=g["rows"], steps=steps,
            wall_s=f"{g['wall_s']:.3f}", capture_s=f"{g['capture_s']:.3f}",
            captured_ms_per_round=f"{g['ms_per_round']:.4f}",
            trajectory_rounds_per_s=f"{g['trajectory_rounds_per_s']:.1f}",
            vs_phase3_decafork=f"{g['vs_phase3_decafork']:.3f}",
            eager_ms_per_round=f"{eager:.4f}",
            captured_speedup=f"{eager / g['ms_per_round']:.2f}",
            whole_round_launches=g["whole_round_launches"],
            graph_kernel_nodes=g["graph_kernel_nodes"])
    start = min(PAPER["protocol_start"], steps - 1)
    burst = PAPER["bursts"][0]
    per = {}
    for s in scen:
        out = res[s.name]
        z = out.z.cpu().numpy()
        if z.shape != (seeds, steps):
            raise AssertionError(f"{s.name}: z has shape {z.shape}")
        if not np.isfinite(out.theta_mean.cpu().numpy()).all():
            raise AssertionError(f"{s.name}: non-finite theta_mean")
        alive = float((z > 0).all(axis=1).mean())
        mean_z = float(z[:, start:].mean())
        react = ([sim.reaction_time(zs, PAPER["z0"], burst) for zs in z]
                 if steps > burst else [])
        done = [r for r in react if r >= 0]
        per[s.name] = dict(survival=alive, mean_z_after_start=mean_z, max_z=int(z.max()),
                           reaction_after_burst_mean=float(np.mean(done)) if done else None,
                           reaction_never=len(react) - len(done),
                           forks=int(out.forks.sum()), terms=int(out.terms.sum()))
        log("sweep", scenario=repr(s.name), survival=alive, mean_z=f"{mean_z:.3f}",
            max_z=int(z.max()), reaction_after_burst=per[s.name]["reaction_after_burst_mean"],
            never_recovered=per[s.name]["reaction_never"], forks=per[s.name]["forks"],
            terms=per[s.name]["terms"])
        if s.pcfg.algorithm != "missingperson" and (
                alive < 1.0 or not PAPER["z0"] / 2 <= mean_z <= 2 * PAPER["z0"]):
            raise AssertionError(f"{s.name}: survival {alive}, mean Z after start {mean_z}")
    return dict(steps=steps, seeds=seeds, decisions=decisions, groups=groups,
                scenarios=per), counts


def sweep_parity(graph):
    """At full width for 200 steps, with decisions from step 50 and the
    rules firing: each scenario of a cuda sweep equals its own cuda
    ensemble (integers bitwise), and a 4-seed mixed sweep (the three
    algorithms and ``none``) on cuda equals the same sweep on the CPU."""
    import numpy as np

    from repro_torch.api import Experiment
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.sweep import Scenario

    steps = 200
    fail = dict(burst_times=(100, 150), burst_sizes=PAPER["burst_sizes"])
    scen = figure_scenarios(50, fail, eps_mp=100.0)
    sweep = Experiment(graph=graph, scenarios=scen, steps=steps, outputs="full",
                       device="cuda").sweep(seeds=PAPER["seeds"])
    for s in scen:
        ens = Experiment(graph=graph, protocol=s.pcfg, failures=s.fcfg, steps=steps,
                         outputs="full", device="cuda").ensemble(PAPER["seeds"])
        int_outputs_equal(sweep[s.name], ens, f"sweep vs ensemble {s.name}")
    forks = {s.name: int(sweep[s.name].forks.sum()) for s in scen}
    if min(forks.values()) == 0:
        raise AssertionError(f"a rule never fired in the parity sweep: {forks}")
    log("parity", sweep="cuda sweep vs cuda ensembles", scenarios=len(scen), steps=steps,
        seeds=PAPER["seeds"], integers="bitwise")

    mixed = scen[1:2] + scen[4:]  # decafork eps=2.0, decafork+, missingperson
    p0 = mixed[0].pcfg
    mixed.append(Scenario("none", ProtocolConfig(
        algorithm="none", z0=p0.z0, max_walks=p0.max_walks, rt_bins=p0.rt_bins,
        protocol_start=50, estimator_impl="auto"), FailureConfig(**CHURN)))
    mixed = [s._replace(fcfg=FailureConfig(**CHURN)) for s in mixed]
    runs = {dev: Experiment(graph=graph, scenarios=mixed, steps=steps, outputs="full",
                            device=dev).sweep(seeds=4) for dev in ("cuda", "cpu")}
    err = 0.0
    for s in mixed:
        got, want = runs["cuda"][s.name], runs["cpu"][s.name]
        int_outputs_equal(got, want, f"mixed sweep cuda vs cpu {s.name}")
        theta = got.theta_mean.cpu().numpy()
        np.testing.assert_allclose(theta, want.theta_mean.numpy(), rtol=1e-6, atol=1e-6)
        err = max(err, float(np.abs(theta - want.theta_mean.numpy()).max()))
    log("parity", sweep="mixed, cuda vs cpu", scenarios=len(mixed), steps=steps, seeds=4,
        integers="bitwise", theta_mean_max_abs_err=err)
    return dict(steps=steps, seeds=PAPER["seeds"], forks=forks, mixed_theta_mean_max_abs_err=err)


# ---------------------------------------------------------------------------
# phase 8: the zoo (Fig. 9's grid at its full widths)
# ---------------------------------------------------------------------------


def split_sweep(graph, steps=SPLIT["steps"], seeds=PAPER["seeds"]):
    """Phase 7 (c): Fig. 5's DecAFork eps grid (4 scenarios x ``seeds``
    rows, the main path's setting, bursts moved inside ``steps``) as one
    ``sweep_group`` on one device, and with the placement's device list
    set to ``cuda:0`` ``SPLIT["devices"]`` times (``"sharded"``): two
    blocks of scenarios, each with its own runner, cache slot, capture and
    host thread. The split run must be bitwise the one-device run (final
    state and outputs), each block's round must hold one whole_round
    node, and whole_round must launch once per round per block plus each
    capture's warm-up round. Each is run twice; the second runs are timed
    (ms per round, no capture). Returns the result and whole_round's
    launches."""
    import torch

    from repro_torch.api import Experiment, placement
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import whole_round

    fail = dict(burst_times=(steps // 3, 2 * steps // 3), burst_sizes=PAPER["burst_sizes"])
    scen = figure_scenarios(steps // 6, fail, EPS_MP)[:len(EPS_GRID)]
    k = SPLIT["devices"]
    res, outs, launches = dict(steps=steps, seeds=seeds, scenarios=len(scen), blocks=k), {}, 0
    visible = placement._visible_devices
    try:
        for label, policy in (("one_device", "local"), ("split", "sharded")):
            if label == "split":
                placement._visible_devices = lambda device: [torch.device("cuda", 0)] * k
            plan = Experiment(graph=graph, scenarios=scen, steps=steps, outputs="full",
                              device="cuda", placement=policy).plan()
            slots = set(plan_mod._EXECUTABLES)
            before = whole_round.launches
            outs[label] = plan.sweep_group(scen, seeds=seeds)
            new = [r for key, r in plan_mod._EXECUTABLES.items() if key not in slots]
            if len(new) != (1 if label == "one_device" else k):
                raise AssertionError(f"phase 7 (c) {label}: {len(new)} new runners")
            for r in new:
                graph_launches(r, f"phase 7 (c) {label}", {"whole_round": 1})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = plan.sweep_group(scen, seeds=seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grew = whole_round.launches - before
            want = len(new) * (2 * steps + 1)
            if grew != want:
                raise AssertionError(f"phase 7 (c) {label}: whole_round launched {grew} times, "
                                     f"expected {want}")
            launches += grew
            again, outs[label] = ((st, tuple(rec)) for st, rec in (again, outs[label]))
            same_leaves(again, outs[label], f"phase 7 (c) {label}: run to run")
            res[label] = dict(runners=len(new), ms_per_round=wall * 1e3 / steps,
                              capture_s=[r.capture_s for r in new],
                              whole_round_launches=grew)
    finally:
        placement._visible_devices = visible
    same_leaves(outs["split"], outs["one_device"], "phase 7 (c): split vs one device")
    res["split_vs_one_device"] = "bitwise"
    log("split_sweep", rows=len(scen) * seeds, steps=steps, blocks=k,
        one_device_ms_per_round=f"{res['one_device']['ms_per_round']:.4f}",
        split_ms_per_round=f"{res['split']['ms_per_round']:.4f}",
        whole_round_launches=launches, outputs="split bitwise one device")
    return res, launches


def same_leaves(a, b, label):
    """Every tensor of two trees equal bitwise (floats by their bits)."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    a, b = tree_leaves(a), tree_leaves(b)
    if len(a) != len(b) or not a:
        raise AssertionError(f"{label}: another structure")
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: differs")


def path_kernel(runner):
    """The kernel a cached runner's round launches once per round:
    whole_round for a fused round, else its estimator's (round_update
    for ``"fused"``, theta_sums for ``"pallas"``) where the algorithm
    estimates theta, else none."""
    from repro_torch.core import simulator as sim
    from repro_torch.kernels import round_update, theta_sums, whole_round

    pcfg = runner.setup.pcfg
    if runner.decision.fused:
        return whole_round
    if pcfg.algorithm not in ("decafork", "decafork+"):
        return None
    impl = sim.resolved_estimator_impl(pcfg)
    if impl == "fused" and runner.setup.pi is None:
        return round_update
    return theta_sums if impl == "pallas" else None


def expected_launches(slots_before, rounds_by_slot):
    """Kernel name -> launches a run of cached runners must have made:
    ``rounds_by_slot`` (cache key -> rounds replayed) rounds of each
    runner's kernel, plus one warm-up round for each slot that is new
    since ``slots_before``."""
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import KERNELS

    want = {k.__name__: 0 for k in KERNELS}
    for key, rounds in rounds_by_slot.items():
        kern = path_kernel(plan_mod._EXECUTABLES[key])
        if kern is not None:
            want[kern.__name__] += rounds + (key not in slots_before)
    return want


def sweep_groups(graph, scenarios, steps, seeds, device):
    """Every sweep group of ``scenarios`` for ``steps`` rounds x ``seeds``
    seeds on ``device``: [(group indices, final state, outputs)]."""
    from repro_torch.api import Experiment
    from repro_torch.figures import common

    plan = Experiment(graph=graph, scenarios=scenarios, steps=steps, outputs="full",
                      device=device, partitionable=common.PARTITIONABLE).plan()
    return [(idxs, *plan.sweep_group([scenarios[i] for i in idxs], seeds=seeds))
            for _sig, idxs in plan.groups()]


def zoo_experiment(steps, device):
    """Fig. 9's grid at phase 8's setting (``ZOO``), ``steps`` rounds."""
    from repro_torch.figures import fig9_zoo

    z = ZOO
    return fig9_zoo.experiment(device=device, steps=steps, proto_start=z["protocol_start"],
                               attack_at=fig9_zoo.attack_time(z["steps"], z["protocol_start"]),
                               n=z["n"])


def figure_parity_cases():
    """[(driver, graph, scenarios)] of phase 9's parity window: each
    driver's groups with its ``FIGURES`` events; a scenario an earlier
    driver ran on the same graph is left out."""
    import importlib

    cases, seen = [], set()
    for name, module, events in FIGURES:
        mod = importlib.import_module(f"repro_torch.figures.{module}")
        for graph, scen in mod.scenarios(**events):
            keys = [(graph.neighbors.tobytes(), repr((s.pcfg, s.fcfg))) for s in scen]
            scen = [s for s, key in zip(scen, keys) if key not in seen]
            seen.update(keys)
            if scen:
                cases.append((name, graph, scen))
    return cases


def cpu_runs(what):
    """The CPU side of phase 8's (``"zoo"``), phase 9's (``"figures"``),
    phase 10's (``"rwsgd"``) or phase 15's (``"large"``) parity, run in a
    child process (:func:`start_cpu_runs`) while the card runs the phases:
    one :func:`sweep_groups` list per case (phase 10:
    :func:`rwsgd_cpu_legs`; phase 15: :func:`large_window` at 1 seed)."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    torch.set_num_threads(CPU_THREADS)
    if what == "rwsgd":
        return rwsgd_cpu_legs()
    if what == "large":
        return large_window("cpu", 1)
    if what == "zoo":
        exp = zoo_experiment(ZOO["parity_steps"], "cpu")
        cases = [(exp.graph, exp.scenarios, ZOO["parity_steps"], ZOO["parity_seeds"])]
    else:
        cases = [(graph, scen, FIGURE_PARITY["steps"], FIGURE_PARITY["seeds"])
                 for _name, graph, scen in figure_parity_cases()]
    # plain tuples and dicts of tensors cross the process boundary
    return [[(idxs, tuple(tree_leaves(final)), {f: getattr(outs, f) for f in outs._fields})
             for idxs, final, outs in sweep_groups(*case, "cpu")] for case in cases]


def start_cpu_runs():
    """One spawned process (it has its own executable cache and no CUDA
    context) that computes :func:`cpu_runs` for phase 8, then phases 9, 10
    and 15, while the card runs phases 14 and 3-12: (pool, {what: pending
    result}); the caller terminates the pool."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, {what: pool.apply_async(cpu_runs, (what,))
                  for what in ("zoo", "figures", "rwsgd", "large")}


def group_parity(graph, scenarios, steps, seeds, label, cpu):
    """Every sweep group of ``scenarios`` for its first ``steps`` rounds x
    ``seeds`` seeds on cuda (the kernels, captured) against ``cpu``, the
    same groups on the CPU from :func:`cpu_runs` (the kernels' plain
    versions): integer outputs and the final carry (the variants'
    ``prev`` / ``bloom`` columns and the Pac-Man positions included)
    bitwise, theta_mean within 1e-6. Returns the largest theta_mean gap
    and, per group, (scenarios, cuda final state, cuda outputs)."""
    import numpy as np

    err, runs = 0.0, []
    cuda = sweep_groups(graph, scenarios, steps, seeds, "cuda")
    if [c[0] for c in cuda] != [c[0] for c in cpu]:
        raise AssertionError(f"{label}: the CPU grouped otherwise")
    for (idxs, gs, go), (_, ws, wo) in zip(cuda, cpu):
        group = [scenarios[i] for i in idxs]
        name = f"{label} {','.join(s.name for s in group)}"
        same_leaves(gs, ws, f"{name}: final carry")
        for f in INT_FIELDS:
            same_leaves((getattr(go, f),), (wo[f],), f"{name}: {f}")
        theta, want = go.theta_mean.cpu().numpy(), wo["theta_mean"].numpy()
        np.testing.assert_allclose(theta, want, rtol=1e-6, atol=1e-6, err_msg=name)
        err = max(err, float(np.abs(theta - want).max()))
        runs.append((group, gs, go))
    return err, runs


def zoo_phase(steps, seeds, cpu):
    """Phase 8: Fig. 9's grid (``benchmarks/fig9_zoo.py`` under
    ``BENCH_FULL=1``) through the port's driver's experiment, one sweep on
    cuda, each group captured and timed; then parity against ``cpu``
    (the pending :func:`cpu_runs` of ``"zoo"``) and captured-vs-eager at
    200 rounds."""
    import numpy as np
    import torch

    from repro_torch.api import plan as plan_mod
    from repro_torch.figures import fig9_zoo
    from repro_torch.kernels import KERNELS

    z = ZOO
    attack_at = fig9_zoo.attack_time(z["steps"], z["protocol_start"])
    exp = zoo_experiment(steps, "cuda")
    plan = exp.plan()
    scen = exp.scenarios
    decisions = {tuple(idxs): d for _sig, idxs, d in plan.round_decisions()}
    groups, stacked = [], plan.sweep_stacked

    def timed(scenarios, **kw):
        slots = set(plan_mod._EXECUTABLES)
        before = {k.__name__: k.launches for k in KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stacked(scenarios, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (key,) = set(plan_mod._EXECUTABLES) - slots
        runner = plan_mod._EXECUTABLES[key]
        grew = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
        want = expected_launches(slots, {key: steps})
        kern = path_kernel(runner)
        graph_launches(runner, scenarios[0].name, {kern.__name__: 1} if kern else {})
        if grew != want:
            raise AssertionError(f"zoo group {[s.name for s in scenarios]}: launches {grew}, "
                                 f"expected {want}")
        replay_s = wall - runner.capture_s
        rows = len(scenarios) * seeds
        groups.append(dict(scenarios=[s.name for s in scenarios], rows=rows, steps=steps,
                           impl=runner.decision.impl, reason=runner.decision.reason,
                           kernel=kern.__name__ if kern else None, wall_s=wall,
                           capture_s=runner.capture_s, ms_per_round=replay_s * 1e3 / steps,
                           trajectory_rounds_per_s=rows * steps / replay_s,
                           launches={k: v for k, v in grew.items() if v},
                           graph_kernel_nodes=runner.graph.kernel_nodes))
        g = groups[-1]
        log("zoo", group=repr(",".join(g["scenarios"])), decision=g["impl"],
            reason=repr(g["reason"]), rows=rows, steps=steps, wall_s=f"{wall:.3f}",
            capture_s=f"{runner.capture_s:.3f}", captured_ms_per_round=f"{g['ms_per_round']:.4f}",
            trajectory_rounds_per_s=f"{g['trajectory_rounds_per_s']:.1f}",
            launches=g["launches"], graph_kernel_nodes=g["graph_kernel_nodes"])
        return out

    plan.sweep_stacked = timed
    for k in KERNELS:  # this path's counts start here
        k.launches = 0
    res = plan.sweep(seeds=seeds)
    counts = {k.__name__: k.launches for k in KERNELS}
    for idxs, d in decisions.items():
        if d.fused:
            raise AssertionError(f"zoo group {idxs} decided fused: the whole_round kernel "
                                 "must never see a variant, Pac-Man slots or an edge cut")
    start = min(z["protocol_start"], steps - 1)
    per = {}
    for s in scen:
        zz = res[s.name].z.cpu().numpy()
        if zz.shape != (seeds, steps) or not np.isfinite(res[s.name].theta_mean.cpu().numpy()).all():
            raise AssertionError(f"{s.name}: z {zz.shape} or non-finite theta_mean")
        post = zz[:, start:]
        per[s.name] = dict(survival=float((zz > 0).all(axis=1).mean()),
                           mean_z_after_start=float(post.mean()), min_z_after_start=int(post.min()),
                           max_z=int(zz.max()), forks=int(res[s.name].forks.sum()),
                           terms=int(res[s.name].terms.sum()))
        log("zoo", scenario=repr(s.name), **per[s.name])
        if s.name.endswith("|none") and (per[s.name]["survival"] < 1.0 or not
                                         Z_BAND[0] <= per[s.name]["mean_z_after_start"] <= Z_BAND[1]):
            raise AssertionError(f"{s.name}: survival {per[s.name]['survival']}, "
                                 f"mean Z after start {per[s.name]['mean_z_after_start']}")
    t0 = time.perf_counter()
    (cpu,) = cpu.get(CPU_TIMEOUT_S)
    log("zoo", cpu_side_wait_s=f"{time.perf_counter() - t0:.1f}")
    parity = zoo_parity(z["parity_steps"], z["parity_seeds"], cpu)
    return dict(steps=steps, seeds=seeds, attack_at=attack_at, groups=groups, scenarios=per,
                parity=parity), counts


def zoo_parity(steps, seeds, cpu):
    """The zoo grid's first ``steps`` rounds x ``seeds`` seeds, every group
    on cuda against the CPU's (``cpu``; :func:`group_parity`); then for a
    ``bloom`` group and a mobile Pac-Man group the captured run against
    the eager loop (outputs and final carry bitwise)."""
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.utils import prng

    exp = zoo_experiment(steps, "cuda")
    err, runs = group_parity(exp.graph, exp.scenarios, steps, seeds, "zoo parity", cpu)
    eager = {}
    keys = prng.split(prng.key(0, device="cuda"), seeds)
    for group, gs, go in runs:
        label = ",".join(s.name for s in group)
        variant = group[0].pcfg.walk_variant
        mobile = group[0].fcfg.pacman_mobile
        case = "bloom" if variant == "bloom" and not mobile else "mobile_pacman" if (
            mobile and variant == "uniform") else None
        if case:
            setup = sim.make_setup(exp.graph, [s.pcfg for s in group for _ in range(seeds)],
                                   [s.fcfg for s in group for _ in range(seeds)], steps, "cuda")
            decision = sim.round_impl_decision(group[0].pcfg, setup.fcfg)
            state = sim.init_state(keys.repeat(len(group), 1), setup)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e_final, e_rec = sim.run_rounds(state, setup, steps, FULL, decision)
            torch.cuda.synchronize()
            eager[case] = (time.perf_counter() - t0) * 1e3 / steps
            same_leaves(gs, e_final, f"zoo {case}: captured vs eager final carry")
            same_leaves(tuple(go), tuple(e_rec), f"zoo {case}: captured vs eager outputs")
            log("zoo", captured_vs_eager=case, group=repr(label), rounds=steps,
                eager_ms_per_round=f"{eager[case]:.4f}", outputs_final_carry="bitwise")
    if set(eager) != {"bloom", "mobile_pacman"}:
        raise AssertionError(f"zoo parity: captured vs eager ran for {sorted(eager)}")
    log("zoo", parity="cuda vs cpu, every group", rounds=steps, seeds=seeds,
        integers_final_carry="bitwise", theta_mean_max_abs_err=err)
    return dict(steps=steps, seeds=seeds, theta_mean_max_abs_err=err,
                eager_ms_per_round=eager)


# ---------------------------------------------------------------------------
# phase 9: the paper's figure drivers
# ---------------------------------------------------------------------------


def finite_row(row) -> bool:
    import math

    vals = []
    for v in row.values():
        if isinstance(v, dict):
            vals += list(v.values())
        else:
            vals.append(v)
    nums = [x for v in vals for x in (v if isinstance(v, list) else [v])
            if isinstance(x, (int, float))]
    return all(math.isfinite(x) for x in nums)


def counted_driver(name, run):
    """``run()`` (a figure driver) with every kernel's launches counted
    from 0: each must equal one per round of the groups whose path it is
    (whole_round in fused groups, round_update in unfused DecAFork groups,
    theta_sums in ``auto_eps``'s auto runs), plus one warm-up round per
    new capture (:func:`expected_launches`). Returns (its result, wall s,
    kernel name -> launches)."""
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import KERNELS

    slots = set(plan_mod._EXECUTABLES)
    replays = {}  # cache key -> rounds its runner ran in this driver
    orig = plan_mod.executable

    def counted(mode, signature, build):
        runner = orig(mode, signature, build)
        replays[(mode, signature)] = replays.get((mode, signature), 0) + runner.steps
        return runner

    for k in KERNELS:  # this driver's counts start here
        k.launches = 0
    plan_mod.executable = counted
    t0 = time.perf_counter()
    try:
        result = run()
    finally:
        plan_mod.executable = orig
    wall = time.perf_counter() - t0
    got = {k.__name__: k.launches for k in KERNELS}
    want = expected_launches(slots, replays)
    if got != want:
        raise AssertionError(f"{name}: kernel launches {got}, expected {want}")
    return result, wall, got


def figure_phase(steps, out, cpu):
    """Phase 9: each port driver of ``FIGURES`` on cuda at its reduced
    setting (``steps`` cuts its rounds where given), its CSV rows
    printed; every row finite, and each kernel launched once per round of
    the groups whose path it is (whole_round in the fused groups,
    round_update in the unfused ones, theta_sums in auto_eps's auto
    runs), plus one warm-up round per new capture. Then each driver's
    groups, on its own graphs and at its own widths, with its events
    moved into the first ``FIGURE_PARITY`` rounds (:func:`figure_parity_cases`),
    on cuda against ``cpu``, the pending :func:`cpu_runs` of ``"figures"``
    (:func:`group_parity`)."""
    import importlib

    from repro_torch.kernels import KERNELS

    res, counts = {}, {k.__name__: 0 for k in KERNELS}
    for name, module, _events in FIGURES:
        mod = importlib.import_module(f"repro_torch.figures.{module}")
        kw = {} if steps is None else dict(steps=steps)
        rounds = steps or mod.STEPS
        rows, wall, got = counted_driver(
            name, lambda: mod.run(verbose=True, device="cuda", out=out, **kw))
        bad = [r["name"] for r in rows if not finite_row(r)]
        if bad:
            raise AssertionError(f"{name}: rows with non-finite values {bad}")
        if not got["whole_round"]:
            raise AssertionError(f"{name}: no fused group launched whole_round")
        if name == "auto_eps" and not got["theta_sums"]:
            raise AssertionError("auto_eps: its auto runs did not launch theta_sums")
        for k, v in got.items():
            counts[k] += v
        res[name] = dict(steps=rounds, wall_s=wall, rows=rows,
                         launches={k: v for k, v in got.items() if v})
        log("figures", driver=name, steps=rounds, wall_s=f"{wall:.1f}", rows=len(rows),
            launches=res[name]["launches"], rows_finite=True)
    t0 = time.perf_counter()
    cpu = cpu.get(CPU_TIMEOUT_S)
    log("figures", cpu_side_wait_s=f"{time.perf_counter() - t0:.1f}")
    events = {name: ev for name, _module, ev in FIGURES}
    for (name, graph, scen), want in zip(figure_parity_cases(), cpu):
        t0 = time.perf_counter()
        err, runs = group_parity(graph, scen, FIGURE_PARITY["steps"], FIGURE_PARITY["seeds"],
                                 f"{name} parity", want)
        par = res[name].setdefault("parity", dict(FIGURE_PARITY, events=events[name], groups=0,
                                                  theta_mean_max_abs_err=0.0, wall_s=0.0))
        par["groups"] += len(runs)
        par["theta_mean_max_abs_err"] = max(par["theta_mean_max_abs_err"], err)
        par["wall_s"] += time.perf_counter() - t0
        log("figures", parity=f"{name} cuda vs cpu", graph=graph.family, n=graph.n,
            scenarios=len(scen), groups=len(runs), events=events[name], **FIGURE_PARITY,
            integers_final_carry="bitwise", theta_mean_max_abs_err=err)
    for r in res.values():
        r.setdefault("parity", "every scenario ran in an earlier driver's window")
    return res, counts


# ---------------------------------------------------------------------------
# phase 10: the RW-SGD payload (walks carrying model replicas)
# ---------------------------------------------------------------------------


def rwsgd_experiment(cfg, steps, device, *, protocol_start, burst_at, task=None):
    """``examples/decentralized_training.py``'s run (``RWSGD``) through the
    port with model ``cfg``: DecAFork on a regular graph, a burst, an
    ``RwSgdPayload`` trained by ``adamw``. ``task`` defaults to the
    chain the example draws (``make_markov_task(vocab)``), on the CPU."""
    from repro_torch.api import Experiment
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.data import make_markov_task
    from repro_torch.graphs import make_graph
    from repro_torch.models.model import Model
    from repro_torch.optim import RwSgdPayload, adamw

    r = RWSGD
    task = task or make_markov_task(cfg.vocab_size, device="cpu")
    payload = RwSgdPayload(Model(cfg), adamw(r["lr"]), task, max_walks=r["max_walks"],
                           local_batch=r["local_batch"], seq_len=r["seq"])
    pcfg = ProtocolConfig("decafork", z0=r["z0"], max_walks=r["max_walks"], eps=r["eps"],
                          protocol_start=protocol_start, rt_bins=r["rt_bins"],
                          estimator_impl="auto")
    fcfg = FailureConfig(burst_times=(burst_at,), burst_sizes=(r["burst_size"],))
    return Experiment(graph=make_graph("regular", r["n"], seed=0, degree=r["degree"]),
                      protocol=pcfg, failures=fcfg, steps=steps, payload=payload, device=device)


def rwsgd_parity_plan(device):
    """Phase 10 (b)'s plan on ``device``: the smoke config, decisions and
    a burst inside ``RWSGD_PARITY``'s window, the task drawn on the CPU
    (the same logits on both devices); and the run's keys."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.utils import prng

    p = RWSGD_PARITY
    plan = rwsgd_experiment(get_smoke_config("paper_rwsgd"), p["steps"], device,
                            protocol_start=p["protocol_start"], burst_at=p["burst_at"]).plan()
    return plan, prng.split(prng.key(0, device=device), p["seeds"])


def rwsgd_cpu_legs():
    """The CPU side of phase 10 (b): the run in legs of
    ``RWSGD_PARITY["leg"]`` rounds through the eager loop (bitwise the
    straight run: every stream folds the carried step counter), with the
    state and the replicas at each leg's start; returns ([(state leaves,
    carry leaves)] per leg, step outputs, payload outputs, final state
    leaves), plain tensors."""
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.utils.tree import tree_clone, tree_leaves

    p = RWSGD_PARITY
    plan, keys = rwsgd_parity_plan("cpu")
    setup = plan._setup(p["seeds"])
    state, carry = sim.init_state(keys, setup), sim.init_payload(keys, setup, plan.payload)
    starts, outs, learns = [], [], []
    for _ in range(0, p["steps"], p["leg"]):
        starts.append(tuple(tuple(tree_leaves(tree_clone(x))) for x in (state, carry)))
        (state, carry), (o, lr) = sim.run_rounds(state, setup, p["leg"], FULL, plan.decision,
                                                 payload=plan.payload, carry=carry)
        outs.append(o)
        learns.append(lr)
    cat = lambda recs: {f: torch.cat([getattr(r, f) for r in recs], dim=1)  # noqa: E731
                        for f in recs[0]._fields}
    return starts, cat(outs), cat(learns), tuple(tree_leaves(state))


def train_curve(learn):
    """Mean loss per round over the seeds' rounds that trained."""
    import numpy as np

    trained = learn.trained.cpu().numpy() > 0
    loss = np.where(trained, learn.mean_loss.cpu().numpy(), np.nan)
    return np.nanmean(loss, axis=0)


def top_kernels(events, rounds, k=8):
    """The ``k`` kernels of a profiled window with the most device time:
    [(name, ms per round, launches per round)]."""
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:k]
    return [(e.key[:60], round(e.self_device_time_total / rounds / 1e3, 4), e.count / rounds)
            for e in rows]


def rwsgd_train(steps, seeds):
    """Phase 10 (a): the paper's training path at full width, captured
    (``RWSGD``); returns (its numbers, whole_round's launches)."""
    import numpy as np
    import torch

    from repro_torch.api import plan as plan_mod
    from repro_torch.configs import get_config
    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.kernels import KERNELS, whole_round
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    r = RWSGD
    torch.cuda.reset_peak_memory_stats()
    plan = rwsgd_experiment(get_config("paper_rwsgd"), steps, "cuda",
                            protocol_start=r["protocol_start"], burst_at=r["burst_at"]).plan()
    if not plan.decision.fused:
        raise AssertionError(f"phase 10: the round did not fuse: {plan.decision.reason}")
    payload, setup = plan.payload, plan._setup(seeds)
    keys = prng.split(prng.key(0, device="cuda"), seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = sim.init_payload(keys, setup, payload)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x[0, 0].numel() for x in tree_leaves(carry.params))
    del carry
    for k in KERNELS:  # the main path's counts start here
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (final, replicas), (outs, learn) = plan._execute("ensemble", keys, setup, plan.fcfg,
                                                     plan.decision)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = whole_round.launches
    (key, runner), = [(k, rn) for k, rn in plan_mod._EXECUTABLES.items()
                      if rn.payload is payload]
    graph_launches(runner, "phase 10", {"whole_round": 1})
    if launches != steps + 1:
        raise AssertionError(f"phase 10: whole_round launched {launches} times "
                             f"for {steps} rounds and the capture's warm-up round")
    replay_s = wall - runner.capture_s - init_s
    z = outs.z.cpu().numpy()
    curve = train_curve(learn)
    first, last = float(np.nanmean(curve[:100])), float(np.nanmean(curve[-100:]))
    survival = float((z > 0).all(axis=1).mean())
    trained = int(learn.trained.sum())
    a = dict(steps=steps, seeds=seeds, params_per_replica=n_params,
             replicas=seeds * r["max_walks"], init_s=init_s, capture_s=runner.capture_s,
             wall_s=wall, ms_per_round=replay_s * 1e3 / steps,
             trajectory_rounds_per_s=seeds * steps / replay_s,
             trained_replica_steps_per_s=trained / replay_s,
             trained_tokens_per_s=trained * r["local_batch"] * r["seq"] / replay_s,
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
             graph_kernel_nodes=runner.graph.kernel_nodes, survival=survival,
             z_before_burst=float(z[:, max(r["burst_at"] - 100, 0):r["burst_at"]].mean()),
             z_end=float(z[:, -100:].mean()), loss_first_100=first, loss_last_100=last,
             entropy_floor=payload.task.entropy, forks=int(outs.forks.sum()),
             whole_round_launches=launches)
    log("rwsgd", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in a.items()})
    log("rwsgd", loss_per_100_rounds=[round(float(np.nanmean(curve[i:i + 100])), 4)
                                      for i in range(0, steps, 100)])
    del replicas, final
    plan_mod._EXECUTABLES.pop(key)  # frees the runner's static replicas and its graph
    del runner
    # the first RWSGD_EAGER rounds through the eager loop against the
    # captured run's, and against a captured run of that length (its
    # final replicas), run twice: the second replay bitwise the first
    w = RWSGD_EAGER
    short = sim.make_setup(plan.graph, [plan.pcfg] * seeds, [plan.fcfg] * seeds, w, "cuda")
    fresh = lambda st: (sim.init_state(keys, st), st,  # noqa: E731
                        sim.init_payload(keys, st, payload))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _, carry = fresh(short)
    e_final, (e_outs, e_learn) = sim.run_rounds(state, short, w, FULL, plan.decision,
                                                payload=payload, carry=carry)
    torch.cuda.synchronize()
    a["eager_ms_per_round"] = (time.perf_counter() - t0) * 1e3 / w
    head = lambda rec: tuple(v[:, :w] for v in rec)  # noqa: E731
    same_leaves(tuple(e_outs) + tuple(e_learn), head(outs) + head(learn),
                f"phase 10: the eager loop's first {w} rounds")
    runner_w = sim.RoundRunner(short, FULL, plan.decision, payload)
    c_final, _ = runner_w.run(*fresh(short))
    same_leaves(e_final, c_final, f"phase 10: {w} rounds' final state and replicas")
    c2_final, (c2_outs, c2_learn) = runner_w.run(*fresh(short))
    same_leaves(c2_final, c_final, "phase 10: the second captured run's final replicas")
    same_leaves(tuple(c2_outs) + tuple(c2_learn), tuple(e_outs) + tuple(e_learn),
                "phase 10: the second captured run's outputs")
    a["second_run"] = "bitwise"
    del e_final, c_final, c2_final, runner_w
    # the busy share: a short captured run under torch.profiler (a window
    # keeps about 110,000 kernel records)
    pr = RWSGD_PROFILE
    prof = sim.make_setup(plan.graph, [plan.pcfg] * seeds, [plan.fcfg] * seeds, pr, "cuda")
    runner_p = sim.RoundRunner(prof, FULL, plan.decision, payload)
    runner_p.run(*fresh(prof))  # captures
    args = fresh(prof)
    _seen, events, wall_us = device_launches(lambda: runner_p.run(*args))
    busy = sum(e.self_device_time_total for e in events)
    a.update(eager_vs_captured="bitwise", profiled_rounds=pr, device_busy_share=busy / wall_us,
             device_kernel_ms_per_round=busy / pr / 1e3,
             device_kernels_per_round=sum(e.count for e in events) / pr,
             top_kernels=top_kernels(events, pr))
    del runner_p, args
    torch.cuda.empty_cache()
    log("rwsgd", eager_ms_per_round=f"{a['eager_ms_per_round']:.3f}", eager_rounds=w,
        eager_vs_captured="bitwise (integers, losses, final replicas)",
        second_captured_run="bitwise",
        device_busy_share=f"{a['device_busy_share']:.4f}",
        device_kernel_ms_per_round=f"{a['device_kernel_ms_per_round']:.3f}",
        device_kernels_per_round=f"{a['device_kernels_per_round']:.0f}")
    log("rwsgd", top_kernels_ms_per_round=a["top_kernels"])
    if survival < 1.0:
        raise AssertionError(f"phase 10: Z_t died (survival {survival})")
    if not last < first:
        raise AssertionError(f"phase 10: the loss did not fall ({first} -> {last})")
    return a, launches


def rwsgd_parity(cpu):
    """Phase 10 (b): the parity run captured on cuda against the CPU's
    legs (``cpu``, the pending :func:`cpu_runs` of ``"rwsgd"``). The whole
    run: integers, ``trained`` and the final state bitwise. Each leg
    again on cuda, eagerly, from the CPU's state and replicas at its
    start: integers bitwise, the leg's first-round per-slot losses within
    1e-5 (the same weights and batch), ``mean_loss`` within
    ``RWSGD_LOSS_BOUND`` over the leg. Adam's steps follow sign(g), so
    the free-running losses drift apart by more than that bound over 60
    rounds on any two implementations (ulp-level gradient differences);
    the legs hold every round of the run to the CPU's from a shared
    state. Returns (its numbers, whole_round's launches)."""
    import torch

    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.kernels import whole_round
    from repro_torch.utils.tree import tree_leaves, tree_replace

    p = RWSGD_PARITY
    plan, keys = rwsgd_parity_plan("cuda")
    setup = plan._setup(p["seeds"])
    before = whole_round.launches
    t0 = time.perf_counter()
    (final, _carry), (outs, learn) = plan._execute("ensemble", keys, setup, plan.fcfg,
                                                   plan.decision)
    launches = whole_round.launches - before
    t1 = time.perf_counter()
    starts, w_outs, w_learn, w_final = cpu.get(CPU_TIMEOUT_S)
    log("rwsgd", cpu_side_wait_s=f"{time.perf_counter() - t1:.1f}")
    same_leaves(tuple(tree_leaves(final)), w_final, "phase 10 parity: final state")
    for f in INT_FIELDS:
        same_leaves((getattr(outs, f),), (w_outs[f],), f"phase 10 parity: {f}")
    same_leaves((learn.trained,), (w_learn["trained"],), "phase 10 parity: trained")
    L = p["leg"]
    free = float((learn.mean_loss.cpu() - w_learn["mean_loss"]).abs().max())
    legs = []
    like_state, like_carry = sim.init_state(keys, setup), sim.init_payload(keys, setup,
                                                                           plan.payload)
    for i, (st, ca) in enumerate(starts):
        state = tree_replace(like_state, [x.cuda() for x in st])
        carry = tree_replace(like_carry, [x.cuda() for x in ca])
        _, (o, lr) = sim.run_rounds(state, setup, L, FULL, plan.decision, payload=plan.payload,
                                    carry=carry)
        span = slice(i * L, (i + 1) * L)
        for f in INT_FIELDS:
            same_leaves((getattr(o, f),), (w_outs[f][:, span],), f"phase 10 leg {i}: {f}")
        same_leaves((lr.trained,), (w_learn["trained"][:, span],), f"phase 10 leg {i}: trained")
        first = float((lr.loss[:, 0].cpu() - w_learn["loss"][:, span][:, 0]).abs().max())
        mean = float((lr.mean_loss.cpu() - w_learn["mean_loss"][:, span]).abs().max())
        legs.append(dict(start=i * L, first_round_loss_max_abs_err=first,
                         mean_loss_max_abs_err=mean, forks=int(o.forks.sum())))
        if first > 1e-5 or mean > RWSGD_LOSS_BOUND:
            raise AssertionError(f"phase 10 leg {i}: first-round losses {first} (1e-5), "
                                 f"mean_loss {mean} ({RWSGD_LOSS_BOUND})")
    res = dict(p, integers_trained_final_state="bitwise", legs=legs, bound=RWSGD_LOSS_BOUND,
               free_running_mean_loss_max_abs_err=free, wall_s=time.perf_counter() - t0)
    log("rwsgd", parity="cuda vs cpu", **p, integers_trained_final_state="bitwise",
        legs=legs, free_running_mean_loss_max_abs_err=free)
    torch.cuda.empty_cache()
    return res, launches


def fig8_full(out):
    """Phase 10 (c): Fig. 8's driver at its ``BENCH_FULL`` scale, every
    kernel launch counted (:func:`counted_driver`); returns (its numbers,
    launches by kernel)."""
    from repro_torch.figures import fig8_learning

    f8 = FIG8_FULL
    rows, wall, got = counted_driver(
        "fig8", lambda: fig8_learning.run(verbose=True, device="cuda", out=out, **f8))
    saved = json.load(open(os.path.join(out, "fig8_learning.json")))
    if saved["new_cache_slots"] > len(fig8_learning.ALGS):
        raise AssertionError(f"fig8: {saved['new_cache_slots']} new cache slots")
    if not got["whole_round"]:
        raise AssertionError("fig8: no fused group launched whole_round")
    dead = [x["name"] for x in rows if not x["name"].startswith("fig8/none")
            and not (x["trained_final"] > 0 and x["loss_final"] is not None)]
    if dead:
        raise AssertionError(f"fig8: rows that stopped training {dead}")
    res = dict(f8, wall_s=wall, new_cache_slots=saved["new_cache_slots"],
               launches={k: v for k, v in got.items() if v}, rows=rows)
    log("fig8", **f8, wall_s=f"{wall:.1f}", new_cache_slots=saved["new_cache_slots"],
        launches=res["launches"])
    return res, got


def payload_phase(steps, seeds, cpu, out):
    """Phase 10: (a) :func:`rwsgd_train`, (b) :func:`rwsgd_parity`, (c)
    :func:`fig8_full`; returns (results, launches by kernel)."""
    from repro_torch.kernels import KERNELS

    counts = {k.__name__: 0 for k in KERNELS}
    train, counts["whole_round"] = rwsgd_train(steps, seeds)
    parity, n = rwsgd_parity(cpu)
    counts["whole_round"] += n
    fig8, got = fig8_full(out)
    for k, v in got.items():
        counts[k] += v
    return dict(train=train, parity=parity, fig8=fig8), counts


# ---------------------------------------------------------------------------
# phase 11: durable execution and the experiment service
# ---------------------------------------------------------------------------


def timed_store(root):
    """A ``ResultStore`` at ``root`` that times its boundary writes and
    records their bytes, and the step each resume starts from (phase 11).
    A write's time starts once the device has finished the segment (the
    snapshot's copy to the host would wait for it)."""
    import torch

    from repro_torch.api import ResultStore

    class Timed(ResultStore):
        def put_segment(self, key, steps_done, snapshot, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().put_segment(key, steps_done, snapshot, **kw)
            size = os.path.getsize(self._segment_base(key, steps_done) + ".npz")
            self.writes.append(dict(steps_done=steps_done, s=time.perf_counter() - t0,
                                    bytes=size))

        def latest_segment(self, key, max_steps=None, device="cpu"):
            t0 = time.perf_counter()
            found = super().latest_segment(key, max_steps, device)
            self.resumed_at = None if found is None else found[0]
            self.load_s = time.perf_counter() - t0
            return found

    store = Timed(root)
    store.writes, store.resumed_at, store.load_s = [], None, 0.0
    return store


def durable_child(steps, seg, root):
    """Phase 11 (a)'s child process: phase 3's DecAFork ensemble in
    segments of ``seg`` rounds with boundary snapshots in ``root``, until
    its parent kills it."""
    from repro_torch.api import ResultStore
    from repro_torch.graphs import make_graph

    graph = make_graph("regular", PAPER["n"], seed=0, degree=PAPER["degree"])
    main_experiment(graph, "decafork", steps).plan().ensemble_segmented(
        PAPER["seeds"], segment_steps=seg, store=ResultStore(root))


def durable_resume(graph, steps, phase3):
    """Phase 11 (a): phase 3's DecAFork ensemble through
    ``Plan.ensemble_segmented`` in a spawned child that the parent
    SIGKILLs once the store holds a snapshot at 4/9 of the run; then the
    same line here, which must resume from the latest intact snapshot,
    capture no graph, launch whole_round once per round it replays (read
    from the graph) and end bitwise phase 3's straight captured run.
    Returns (its numbers, whole_round's launches)."""
    import multiprocessing
    import shutil
    import signal

    import torch

    from repro_torch.api import cache_stats
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import whole_round

    seeds, seg = PAPER["seeds"], max(1, steps // 9)
    kill_at = 4 * seg
    root = os.path.join(ROOT, "chiprun_out", "durable")
    shutil.rmtree(root, ignore_errors=True)
    plan = main_experiment(graph, "decafork", steps).plan()
    sig = plan._signature("ensemble", plan.pcfg, plan.fcfg, plan.decision, seeds)
    store = timed_store(root)
    skey = store.sweep_key(sig, graph, (plan.pcfg, plan.fcfg), seeds, plan_mod._as_key(0, "cpu"))
    intact = lambda: [d for d in store.segment_steps_on_disk(skey)  # noqa: E731
                      if os.path.exists(store._segment_base(skey, d) + ".meta.json")]
    child = multiprocessing.get_context("spawn").Process(target=durable_child,
                                                          args=(steps, seg, root))
    t0 = time.perf_counter()
    child.start()
    try:
        while not any(d >= kill_at for d in intact()):
            if not child.is_alive():
                raise AssertionError(f"phase 11: the child exited ({child.exitcode}) before a "
                                     f"snapshot at {kill_at} steps")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("phase 11: no snapshot within 300 s")
            time.sleep(0.02)
        os.kill(child.pid, signal.SIGKILL)
    finally:
        child.join(60)
        if child.is_alive():
            child.kill()
            child.join()
    child_s = time.perf_counter() - t0
    if child.exitcode != -signal.SIGKILL:
        raise AssertionError(f"phase 11: the child ended with {child.exitcode}, not SIGKILL")
    latest = max(intact())
    runner = plan_mod._EXECUTABLES[("ensemble", sig)]  # phase 3's slot
    graph_launches(runner, "phase 11", {"whole_round": 1})
    st = cache_stats()
    before = whole_round.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = plan.ensemble_segmented(seeds, segment_steps=seg, store=store)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = whole_round.launches - before
    replayed = steps - store.resumed_at if store.resumed_at is not None else None
    if store.resumed_at != latest:
        raise AssertionError(f"phase 11: resumed at {store.resumed_at}, the latest intact "
                             f"snapshot is {latest}")
    if cache_stats() != st:
        raise AssertionError(f"phase 11: the resumed run captured ({st} -> {cache_stats()})")
    if launches != replayed * runner.graph.per_replay[whole_round]:
        raise AssertionError(f"phase 11: whole_round launched {launches} times for "
                             f"{replayed} replayed rounds")
    same_leaves(tuple(rec), tuple(phase3["outs"]), "phase 11: resumed vs phase 3's straight run")
    if store.segment_steps_on_disk(skey):
        raise AssertionError("phase 11: the finished run left snapshots")
    write_s = sum(w["s"] for w in store.writes)
    ms_round = (wall - write_s - store.load_s) * 1e3 / replayed
    res = dict(steps=steps, seeds=seeds, segment_steps=seg, kill_at=kill_at,
               child_s=child_s, resumed_at=store.resumed_at, replayed_rounds=replayed,
               whole_round_launches=launches, wall_s=wall, load_s=store.load_s,
               writes=store.writes, write_s_per_boundary=write_s / max(1, len(store.writes)),
               bytes_per_snapshot=[w["bytes"] for w in store.writes],
               ms_per_round=ms_round, phase3_ms_per_round=phase3["ms_per_round"],
               outputs="bitwise phase 3's straight captured run", new_captures=0)
    log("durable", killed="SIGKILL", child_s=f"{child_s:.1f}", resumed_at=store.resumed_at,
        replayed_rounds=replayed, load_s=f"{store.load_s:.3f}",
        bytes_per_snapshot=res["bytes_per_snapshot"],
        write_s_per_boundary=f"{res['write_s_per_boundary']:.3f}",
        ms_per_round=f"{ms_round:.4f}", phase3_ms_per_round=f"{phase3['ms_per_round']:.4f}",
        whole_round_launches=launches, new_captures=0,
        outputs="bitwise phase 3's straight captured run")
    shutil.rmtree(root, ignore_errors=True)  # the snapshots are ~100 MB each
    return res, launches


def service_callers(graph):
    """Phase 11 (b): phase 7's scenarios (Figs. 1 and 5) at 600 steps,
    decisions from step 50 and the bursts at 200 and 400, split over three
    caller threads that submit in turn to one ``ExperimentService``
    (background worker, a store); the main thread keeps launching CUDA
    work and synchronising on it while the worker captures. The calls
    must coalesce into phase 7's three groups, survive one injected
    TransientFault at ``service.run_group`` by a retry, and give each
    caller rows bitwise a private ``sweep`` of its scenarios; the same
    three submissions again must be store hits that run no round and
    capture nothing. Returns (its numbers, whole_round's launches)."""
    import shutil
    import threading

    import torch

    from repro_torch.api import Experiment, ExperimentService, cache_stats
    from repro_torch.core import simulator as sim
    from repro_torch.kernels import whole_round
    from repro_torch.utils.faults import FaultPlan, Raise, TransientFault

    steps, seeds = 600, PAPER["seeds"]
    scen = figure_scenarios(50, dict(burst_times=(200, 400), burst_sizes=PAPER["burst_sizes"]),
                            eps_mp=200.0)
    callers = [scen[0:2], scen[2:3] + scen[4:5], scen[3:4] + scen[5:6]]
    exp = Experiment(graph=graph, scenarios=scen, steps=steps, outputs="full", device="cuda")
    root = os.path.join(ROOT, "chiprun_out", "service")
    shutil.rmtree(root, ignore_errors=True)
    state = {"capturing": False, "work_during_capture": 0, "runs": 0}
    real_captured, real_run = sim.Captured, sim.RoundRunner.run

    class Watched(real_captured):
        def __init__(self, *a, **kw):
            state["capturing"] = True
            try:
                super().__init__(*a, **kw)
            finally:
                state["capturing"] = False

    def counted_run(self, *a, **kw):
        state["runs"] += 1
        return real_run(self, *a, **kw)

    def submit_all(svc):
        futures, turns = [None] * 3, [threading.Event() for _ in range(4)]
        turns[0].set()

        def caller(i):
            turns[i].wait(60)
            futures[i] = svc.submit(callers[i], seeds=seeds)
            turns[i + 1].set()

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        a = torch.randn(1024, 1024, device="cuda")
        work = 0
        while not turns[3].is_set() or not all(f.done() for f in futures):
            b = a @ a
            if not torch.isfinite(b[0, 0]).item():
                raise AssertionError("phase 11: the caller's CUDA work went wrong")
            work += 1
            state["work_during_capture"] += state["capturing"]
        for t in threads:
            t.join(60)
        return [f.result(timeout=300) for f in futures], work

    sim.Captured, sim.RoundRunner.run = Watched, counted_run
    try:
        st0, launches0 = cache_stats(), whole_round.launches
        svc = ExperimentService(exp, store=root, autostart=True, linger=0.2, backoff=0.0)
        fp = FaultPlan().at("service.run_group", Raise(TransientFault("phase 11")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fp.active():
            first, work = submit_all(svc)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        stats = dict(svc.stats)
        cold_captures = cache_stats()["graphs_captured"] - st0["graphs_captured"]
        runs_cold = state["runs"]
        if stats["batches"] != 3 or stats["retries"] != 1 or stats["splits"] != 0:
            raise AssertionError(f"phase 11: service stats {stats} (3 batches, 1 retry)")
        if fp.pending("service.run_group") or runs_cold != 3:
            raise AssertionError(f"phase 11: {runs_cold} runner runs for 3 groups")
        if state["work_during_capture"] == 0:
            raise AssertionError("phase 11: no caller CUDA work ran during a worker capture")
        st1, runs1 = cache_stats(), state["runs"]
        t1 = time.perf_counter()
        again, _ = submit_all(svc)
        warm_s = time.perf_counter() - t1
        svc.close(timeout=60)
        if state["runs"] != runs1 or cache_stats() != st1 or svc.store.hits != 3:
            raise AssertionError(f"phase 11: the resubmission ran {state['runs'] - runs1} "
                                 f"runs, store hits {svc.store.hits}")
        launches = whole_round.launches - launches0
        for i, (res, res2) in enumerate(zip(first, again)):
            private = exp.plan().sweep(callers[i], seeds=seeds)
            for s in callers[i]:
                same_leaves(tuple(res[s.name]), tuple(private[s.name]),
                            f"phase 11: caller {i} {s.name} vs a private sweep")
                same_leaves(tuple(res2[s.name]), tuple(res[s.name]),
                            f"phase 11: caller {i} {s.name} store hit")
        launches_all = whole_round.launches - launches0
    finally:
        sim.Captured, sim.RoundRunner.run = real_captured, real_run
        shutil.rmtree(root, ignore_errors=True)
    res = dict(steps=steps, seeds=seeds, callers=[[s.name for s in c] for c in callers],
               stats=stats, cold_s=cold_s, cold_captures=cold_captures, warm_s=warm_s,
               caller_cuda_iterations=work, during_capture=state["work_during_capture"],
               coalesced_whole_round_launches=launches, rows="bitwise the private sweeps")
    log("service", callers=3, groups=stats["batches"], coalesced=stats["coalesced"],
        retries=stats["retries"], cold_s=f"{cold_s:.2f}", captures=cold_captures,
        caller_cuda_iterations=work, during_capture=state["work_during_capture"],
        warm_resubmission_s=f"{warm_s:.3f}", warm_runs=0, warm_captures=0,
        rows="bitwise the private sweeps")
    return res, launches_all


def durable_payload():
    """Phase 11 (c): phase 10 (b)'s smoke-config payload run (2 seeds, 60
    rounds) straight, then in segments of 20 with a SimulatedKill at the
    second boundary, then resumed from the store: the losses, every
    output and the final replicas bitwise the straight captured run.
    Returns (its numbers, whole_round's launches)."""
    import shutil

    from repro_torch.kernels import whole_round
    from repro_torch.utils import prng
    from repro_torch.utils.faults import FaultPlan, Kill, SimulatedKill

    p = RWSGD_PARITY
    plan, keys = rwsgd_parity_plan("cuda")
    setup = plan._setup(p["seeds"])
    root = os.path.join(ROOT, "chiprun_out", "durable_payload")
    shutil.rmtree(root, ignore_errors=True)
    before = whole_round.launches
    t0 = time.perf_counter()
    want = plan._execute("ensemble", keys, setup, plan.fcfg, plan.decision)
    sig = plan._signature("ensemble", plan.pcfg, plan.fcfg, plan.decision, p["seeds"])
    store, skey = plan._segment_store(root, sig, (plan.pcfg, plan.fcfg), p["seeds"],
                                      prng.key(0))
    fp = FaultPlan().skip("segment.boundary", 1).at("segment.boundary", Kill())
    try:
        with fp.active():
            plan._execute("ensemble", keys, setup, plan.fcfg, plan.decision, segment_steps=20,
                          store=store, skey=skey)
        raise AssertionError("phase 11: the payload run was not killed")
    except SimulatedKill:
        pass
    resumed_at = store.segment_steps_on_disk(skey)[0]
    got = plan._execute("ensemble", keys, setup, plan.fcfg, plan.decision, segment_steps=20,
                        store=store, skey=skey)
    (s1, c1), (o1, l1) = want
    (s2, c2), (o2, l2) = got
    same_leaves((s1, c1), (s2, c2), "phase 11 payload: final state and replicas")
    same_leaves(tuple(o1) + tuple(l1), tuple(o2) + tuple(l2), "phase 11 payload: outputs")
    launches = whole_round.launches - before
    shutil.rmtree(root, ignore_errors=True)
    res = dict(steps=p["steps"], seeds=p["seeds"], segment_steps=20, killed_at_boundary=2,
               resumed_at=resumed_at, wall_s=time.perf_counter() - t0,
               outputs_losses_final_replicas="bitwise the straight captured run")
    log("durable_payload", **res)
    return res, launches


def durable_phase(graph, steps, phase3):
    """Phase 11: (a) :func:`durable_resume`, (b) :func:`service_callers`,
    (c) :func:`durable_payload`; returns (results, whole_round's
    launches)."""
    resume, n_a = durable_resume(graph, steps, phase3)
    service, n_b = service_callers(graph)
    payload, n_c = durable_payload()
    return dict(resume=resume, service=service, payload=payload), n_a + n_b + n_c


# ---------------------------------------------------------------------------
# phase 12: the node-sharded protocol step
# ---------------------------------------------------------------------------


def cayley_graph(n, degree, seed):
    """A ``degree``-regular Cayley graph of Z_n: node i joins i +- o_k for
    ``degree / 2`` distinct offsets o_k in [1, n/2), drawn from ``seed``
    until they and n are coprime (so it is connected). Built in O(n D):
    the port's generators fill a dense n x n adjacency."""
    import numpy as np

    from repro_torch.graphs.generators import Graph

    rng = np.random.default_rng(seed)
    while True:
        offs = rng.choice(np.arange(1, n // 2), degree // 2, replace=False)
        if np.gcd.reduce(np.append(offs, n)) == 1:
            break
    i = np.arange(n)[:, None]
    nbrs = np.concatenate([(i + offs) % n, (i - offs) % n], axis=1).astype(np.int32)
    return Graph(n=n, neighbors=nbrs, degrees=np.full(n, degree, np.int32), family="cayley")


def random_masks(graph, rng):
    """About 15 % of the nodes and 20 % of the links down (links
    symmetric), as tests/test_distributed.py draws them."""
    import numpy as np
    import torch

    from repro_torch.graphs.state import mirror_indices

    nbrs = graph.neighbors
    edge = rng.random(nbrs.shape) > 0.2
    i, k = np.nonzero(nbrs > np.arange(graph.n)[:, None])
    edge[nbrs[i, k], mirror_indices(graph)[i, k]] = edge[i, k]
    return torch.as_tensor(rng.random(graph.n) > 0.15), torch.as_tensor(edge)


def same_state(got, want, label):
    import torch

    for f, a, b in zip(want._fields, got, want):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{label}: {f} differs")


def sharded_phase(seed=0):
    """Phase 12: the node-sharded step (``repro_torch.core.distributed``).
    (a) NCCL at world size 1 (a ``FileStore`` in a temp dir) on the
    reference's production setting (``SHARDED``): ``rounds`` rounds
    through ``run_sharded``, which over NCCL captures the round as a CUDA
    graph and replays it; the first ``cpu_rounds`` also run eagerly
    (``capture=False``) from the same state and must be bitwise the
    captured ones, and bitwise the same step on the CPU (``mesh=None``).
    Then ms per round of the captured rounds after those (host clock
    ending in a synchronize) beside the eager loop's over
    ``SHARDED_EAGER`` of them (Z bitwise), the capture's seconds and
    kernel nodes, Z's range, the peak device memory above what earlier
    phases keep, the node tables' bytes, and ``SHARDED_PROFILE`` replays
    under torch.profiler (kernels per round, busy share, the kernels with
    the most device time). (b) ``SHARDED_RANKS``: two spawned ranks over gloo on
    CUDA tensors (NCCL refuses two ranks on one device), started beside
    this process's world-size-1 run of the same inputs and bitwise it.
    The step runs no kernel of ``repro_torch.kernels``: their counters
    must not move."""
    import concurrent.futures
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import (ShardedGraph, ShardedProtocolState,
                                              init_sharded_state, make_sharded_step,
                                              run_sharded, shard_state)
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import data_axes, make_local_mesh
    from repro_torch.launch.sharded import spawn_run
    from repro_torch.utils import prng

    S, R = SHARDED, SHARDED_RANKS
    pcfg = ProtocolConfig(algorithm="decafork+", z0=S["z0"], max_walks=S["max_walks"],
                          eps=S["eps"], eps2=S["eps2"], rt_bins=S["rt_bins"])
    n = S["n"]
    g = cayley_graph(n, S["degree"], seed)
    graph_cpu = ShardedGraph(torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees),
                             torch.ones(n, dtype=torch.bool),
                             torch.ones(g.neighbors.shape, dtype=torch.bool))
    state_cpu = init_sharded_state(n, pcfg, prng.key(seed))
    before = {k.__name__: k.launches for k in KERNELS}
    torch.cuda.set_device(0)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            mesh = make_local_mesh(device_type="cuda")
            axes = data_axes(mesh)
            step = make_sharded_step(mesh, axes, n, pcfg)
            if step.backend != "nccl":
                raise AssertionError(f"phase 12 (a): the step's collectives are {step.backend}'s")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()  # what earlier phases keep
            state, graph = shard_state(state_cpu, graph_cpu, mesh, axes, "cuda")
            head, w = S["cpu_rounds"], S["rounds"] - S["cpu_rounds"]
            # the first rounds captured (run_sharded's default over NCCL) and
            # eager from the same state: bitwise
            cap, z_head = run_sharded(step, state, graph, head)
            (runner,) = [r for (_d, captured), r in step.runners.items() if captured]
            eager, z_eager = run_sharded(step, state, graph, head, capture=False)
            same_state(cap, eager, f"phase 12 (a): round {head}, captured vs eager")
            if not torch.equal(z_head, z_eager):
                raise AssertionError("phase 12 (a): Z differs between captured and eager rounds")
            del eager, state
            snap = ShardedProtocolState(*(x.to("cpu", copy=True) for x in cap))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, z_tail = run_sharded(step, cap, graph, w)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the eager loop's ms per round over the first of those rounds
            t1 = time.perf_counter()
            _, z_e = run_sharded(step, cap, graph, SHARDED_EAGER, capture=False)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t1
            if not torch.equal(z_e, z_tail[:SHARDED_EAGER]):
                raise AssertionError("phase 12 (a): the eager window's Z differs from the "
                                     "captured rounds'")
            z = torch.cat([z_head, z_tail]).cpu().numpy()
            peak = torch.cuda.max_memory_allocated() - base
            tables = {f: getattr(state, f).numel() * getattr(state, f).element_size()
                      for f in ("last_seen", "hist", "total")}
            # a short profiled window of replays: kernels per round, busy share
            seen, events, wall_us = device_launches(
                lambda: run_sharded(step, state, graph, SHARDED_PROFILE))
            if any(seen.values()):
                raise AssertionError(f"phase 12: the device ran the repo's kernels: {seen}")
            busy = _busy(events, wall_us, SHARDED_PROFILE)
            top = top_kernels(events, SHARDED_PROFILE, k=4)
            del state, graph, cap
            t1 = time.perf_counter()
            cpu, z_cpu = run_sharded(make_sharded_step(None, ("data",), n, pcfg), state_cpu,
                                     graph_cpu, head)
            cpu_s = time.perf_counter() - t1
            same_state(snap, cpu, f"phase 12 (a): round {head}, cuda vs cpu")
            if not np.array_equal(z[:head], z_cpu.numpy()):
                raise AssertionError("phase 12 (a): Z differs between cuda and the CPU")
            if not 1 <= z.min() <= z.max() <= S["max_walks"]:
                raise AssertionError(f"phase 12 (a): Z left [1, W]: {z.min()}..{z.max()}")
            res["full_width"] = dict(
                n=n, degree=S["degree"], max_walks=S["max_walks"], rt_bins=S["rt_bins"],
                rounds=S["rounds"], timed_rounds=w, ms_per_round=wall * 1e3 / w,
                eager_rounds=SHARDED_EAGER, eager_ms_per_round=eager_s * 1e3 / SHARDED_EAGER,
                capture_s=runner.capture_s,
                graph_kernel_nodes=runner.captured.kernel_nodes,
                z_min=int(z.min()), z_max=int(z.max()), z_final=int(z[-1]),
                peak_memory_mb=peak / 1e6, table_mb={k: v / 1e6 for k, v in tables.items()},
                profiled_rounds=SHARDED_PROFILE, kernels_per_round=busy["kernels_per_step"],
                kernel_ms_per_round=busy["kernel_ms_per_step"], busy_share=busy["busy_share"],
                top_kernels_ms_per_round=top, captured_vs_eager="bitwise",
                cpu_rounds=head, cpu_s=cpu_s, cuda_vs_cpu="bitwise", backend="nccl", world=1)
            log("sharded", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                              for k, v in res["full_width"].items()})

            # (b) two ranks over gloo on the card against world size 1
            t2 = time.perf_counter()
            g = cayley_graph(R["n"], R["degree"], seed + 1)
            node_up, edge_up = random_masks(g, np.random.default_rng(seed))
            graph_b = ShardedGraph(torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees),
                                   node_up, edge_up)
            state_b = init_sharded_state(R["n"], pcfg, prng.key(seed + 1))
            # the two ranks start (imports, CUDA, gloo) while this process
            # runs world size 1: their ms per round is taken beside it
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                ranks = pool.submit(spawn_run, state_b, graph_b, pcfg, R["rounds"],
                                    world=R["world"], device="cuda", backend="gloo")
                one_state, one_graph = shard_state(state_b, graph_b, mesh, axes, "cuda")
                one, z_one = run_sharded(make_sharded_step(mesh, axes, R["n"], pcfg),
                                         one_state, one_graph, R["rounds"])
                two = ranks.result()
            same_state(two["state"], one, "phase 12 (b): two gloo ranks vs world size 1")
            if not torch.equal(two["z"], z_one.cpu()):
                raise AssertionError("phase 12 (b): Z differs between world sizes 2 and 1")
            res["ranks"] = dict(n=R["n"], degree=R["degree"], rounds=R["rounds"],
                                world=R["world"], backend="gloo", device="cuda",
                                ms_per_round=two["seconds"] * 1e3 / R["rounds"],
                                z_min=int(z_one.min()), z_max=int(z_one.max()),
                                vs_world_1="bitwise", wall_s=time.perf_counter() - t2)
            log("sharded", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                              for k, v in res["ranks"].items()})
        finally:
            dist.destroy_process_group()
    moved = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    if any(moved.values()):
        raise AssertionError(f"phase 12 launched kernels: {moved}")
    return res


def large_experiment(n, steps, device):
    """Phase 15's cell on ``device``: SHARDED's protocol through the
    Experiment API (``round_impl="auto"``: the fused round) on a Cayley
    graph of ``n`` nodes with ``LARGE_CHURN``."""
    from repro_torch.api import Experiment
    from repro_torch.core import FailureConfig, ProtocolConfig

    S = SHARDED
    pcfg = ProtocolConfig(algorithm="decafork+", z0=S["z0"], max_walks=S["max_walks"],
                          eps=S["eps"], eps2=S["eps2"], rt_bins=S["rt_bins"],
                          estimator_impl="auto", round_impl="auto")
    return Experiment(graph=cayley_graph(n, S["degree"], 0), protocol=pcfg,
                      failures=FailureConfig(**LARGE_CHURN), steps=steps, outputs="full",
                      device=device)


def large_window(device, seeds):
    """Phase 15's window: ``LARGE["window"]`` rounds at n ``window_n`` of
    the first ``seeds`` rows of the 8-seed ensemble's keys on ``device``:
    (each final-state tensor's row 0 as (shape, dtype, SHA-256 of its
    bytes), {field: row 0 of the outputs on the CPU}). The digests stand
    for the tables (~600 MB at that n), which need not cross the process
    boundary to be compared bit for bit."""
    import hashlib

    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    plan = large_experiment(LARGE["window_n"], LARGE["window"], device).plan()
    keys = prng.split(prng.key(0, device=device), LARGE["seeds"])[:seeds]
    final, rec = plan._execute("ensemble", keys, plan._setup(seeds), plan.fcfg, plan.decision)

    def digest(x):
        x = x[:1].cpu().contiguous()
        return tuple(x.shape), str(x.dtype), hashlib.sha256(x.numpy().tobytes()).hexdigest()

    return ([digest(x) for x in tree_leaves(final)],
            {f: getattr(rec, f)[:1].cpu() for f in rec._fields})


def large_graph_phase(cpu):
    """Phase 15: the large-graph main path (``LARGE``). ``Experiment(...)
    .ensemble(8)`` at n 1,048,576 on cuda, captured: the decision must be
    the fused round, the captured round must hold one whole_round node,
    whole_round must launch once per replayed round plus the capture's
    warm-up round, Z must stay in [1, W] and theta_mean finite; ms per
    round of the replays (capture apart), trajectory-rounds/s, peak
    memory. Then the window at n 262,144 on cuda, row 0 against ``cpu``
    (the pending CPU run of the same inputs at 1 seed): integer outputs
    and the final carry bitwise, theta_mean within 1e-6. Returns the
    result and whole_round's launches."""
    import numpy as np
    import torch

    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import whole_round

    L = LARGE
    exp = large_experiment(L["n"], L["rounds"], "cuda")
    (_, _, decision), = exp.plan().round_decisions()
    if not decision.fused:
        raise AssertionError(f"phase 15 did not fuse: {decision.reason}")
    slots = set(plan_mod._EXECUTABLES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = whole_round.launches
    t0 = time.perf_counter()
    outs = exp.ensemble(L["seeds"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    runner = new_runner(slots)
    graph_launches(runner, "phase 15", {"whole_round": 1})
    launches = whole_round.launches - before
    if launches != L["rounds"] + 1:
        raise AssertionError(f"phase 15: whole_round launched {launches} times for "
                             f"{L['rounds']} replays x 1 graph node and the warm-up round")
    z = outs.z.cpu().numpy()
    if z.shape != (L["seeds"], L["rounds"]) or not 1 <= z.min() <= z.max() <= SHARDED["max_walks"]:
        raise AssertionError(f"phase 15: Z {z.shape} in {z.min()}..{z.max()}")
    if not np.isfinite(outs.theta_mean.cpu().numpy()).all():
        raise AssertionError("phase 15: non-finite theta_mean")
    replay_s = wall - runner.capture_s
    res = dict(n=L["n"], degree=SHARDED["degree"], max_walks=SHARDED["max_walks"],
               rt_bins=SHARDED["rt_bins"], seeds=L["seeds"], rounds=L["rounds"], wall_s=wall,
               capture_s=runner.capture_s, ms_per_round=replay_s * 1e3 / L["rounds"],
               trajectory_rounds_per_s=L["seeds"] * L["rounds"] / replay_s,
               peak_memory_gb=peak / 1e9, graph_kernel_nodes=runner.graph.kernel_nodes,
               whole_round_launches=launches, z_min=int(z.min()), z_max=int(z.max()),
               forks=int(outs.forks.sum()), terms=int(outs.terms.sum()),
               failures=int(outs.failures.sum()))
    del outs, runner, exp
    plan_mod.clear_cache()  # the 1,048,576-node slot's static state (~20 GB)
    torch.cuda.empty_cache()
    log("large", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in res.items()})

    before = whole_round.launches
    gs, go = large_window("cuda", L["seeds"])
    launches += whole_round.launches - before
    ws, wo = cpu.get(timeout=CPU_TIMEOUT_S)
    if gs != ws:
        raise AssertionError("phase 15 window: the final carry's row 0 differs from the CPU's")
    for f in INT_FIELDS:
        same_leaves((go[f],), (wo[f],), f"phase 15 window: {f}")
    np.testing.assert_allclose(go["theta_mean"].numpy(), wo["theta_mean"].numpy(),
                               rtol=1e-6, atol=1e-6)
    if int(wo["forks"].sum()) == 0:
        raise AssertionError("phase 15 window: no fork in the compared rounds")
    res["window"] = dict(n=L["window_n"], rounds=L["window"], seeds_on_cuda=L["seeds"],
                         cpu_rows=1, cuda_vs_cpu="bitwise", forks=int(wo["forks"].sum()),
                         failures=int(wo["failures"].sum()))
    log("large", window=repr(res["window"]))
    plan_mod.clear_cache()
    torch.cuda.empty_cache()
    return res, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=MAIN_STEPS,
                    help=f"main-path rounds (default {MAIN_STEPS}; the paper runs 9000)")
    ap.add_argument("--sweep-steps", type=int, default=SWEEP_STEPS,
                    help=f"phase 7's rounds (default {SWEEP_STEPS}; the paper runs 9000)")
    ap.add_argument("--zoo-steps", type=int, default=ZOO_STEPS,
                    help=f"phase 8's rounds (default {ZOO_STEPS}; Fig. 9's full setting runs "
                         f"{ZOO['steps']})")
    ap.add_argument("--figure-steps", type=int, default=FIGURE_STEPS,
                    help=f"phase 9's rounds per driver (default {FIGURE_STEPS}; the drivers' "
                         "reduced setting runs 4500)")
    ap.add_argument("--rwsgd-steps", type=int, default=RWSGD_STEPS,
                    help=f"phase 10's rounds at full width (default {RWSGD['steps']}, the "
                         "example's)")
    args = ap.parse_args()

    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.api import plan as plan_mod
        from repro_torch.graphs import make_graph
        from repro_torch.kernels import KERNELS, _build
    except ImportError as exc:
        print(f"chip_smoke: the repository's src/repro_torch is missing ({exc})", file=sys.stderr)
        return 1

    phase_s, t_phase = {}, [time.perf_counter()]

    def lap(phase):  # seconds of each phase, host clock
        now = time.perf_counter()
        phase_s[phase] = now - t_phase[0]
        t_phase[0] = now
        log("time", done=repr(phase), s=f"{phase_s[phase]:.1f}",
            total_s=f"{sum(phase_s.values()):.1f}")

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    build = _build.build_all()  # source -> seconds; the sources compile at once
    build_s = max(build.values(), default=0.0)
    log("device", nvidia_smi=repr(smi), torch_device=repr(name),
        torch=torch.__version__, cuda=torch.version.cuda, build_s=f"{build_s:.2f}",
        **{f"build_s_{k}": f"{v:.2f}" for k, v in build.items()})
    sass = {src: sass_check(src) for src in ("flash_attention_sm90", "ssd_intra_chunk_sm90")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    graph = make_graph("regular", PAPER["n"], seed=0, degree=PAPER["degree"])
    lap("1 device and build")
    rows = check_kernels(rng, graph, "cuda") + check_model_kernels(rng, "cuda")
    lap("2 kernels")
    # the CPU side of phases 8-10's parity, in a process beside phases 14
    # and 3-10
    pool, cpu = start_cpu_runs()
    try:
        # phase 14 runs here, while the card holds nothing of the other phases
        # (dbrx-132b's one layer trains in ~54 GB of its 80)
        training = train_phase("cuda")
        lap("14 train")
        by_name = {r["name"]: r for r in rows}

        if args.steps < PAPER["steps"]:
            fired = [b for b in PAPER["bursts"] if b < args.steps]
            log("main", cut=f"steps {args.steps} of the paper's {PAPER['steps']}; bursts at "
                            f"{fired} fire; n, W, B and seeds uncut")
        for k in KERNELS:  # the main path's counts start here
            k.launches = 0
        main_res = main_path(graph, args.steps, PAPER["seeds"], by_name["whole_round"]["device_ms"])
        counts = {k.__name__: k.launches for k in KERNELS}
        log("main", launches=counts)
        lap("3 main path")
        main_eager_windows(graph, PAPER["seeds"], main_res)
        lap("3 eager window")
        profile = profile_rounds(graph, PAPER["seeds"])
        lap("3 profile")
        parity = cross_device(graph)
        lap("4 cross-device parity")
        unfused = unfused_paths(graph, counts)
        lap("5 unfused paths")
        unfused.update(estimator_modes(graph, counts))
        lap("5 estimator modes")
        unfused["device_launches"] = phase5_device_launches(graph)
        lap("5 device launches")
        captured = captured_vs_eager(graph)
        lap("5 captured vs eager")
        serve, serve_counts = serve_models("cuda")
        lap("6 serve")
        counts.update(serve_counts)
        if args.sweep_steps < PAPER["steps"]:
            fired = [b for b in PAPER["bursts"] if b < args.sweep_steps]
            log("sweep", cut=f"steps {args.sweep_steps} of the paper's {PAPER['steps']}; bursts at "
                             f"{fired} fire; n, W, B and seeds uncut")
        sweep, sweep_counts = sweep_phase(graph, args.sweep_steps, PAPER["seeds"], main_res)
        for k, v in sweep_counts.items():
            counts[k] += v
        lap("7 sweep")
        sweep["parity"] = sweep_parity(graph)
        lap("7 sweep parity")
        sweep["split"], split_launches = split_sweep(graph)
        counts["whole_round"] += split_launches
        lap("7 split sweep")
        if args.zoo_steps < ZOO["steps"]:
            log("zoo", cut=f"steps {args.zoo_steps} of Fig. 9's {ZOO['steps']}; n, W, B, seeds "
                           "uncut")
        zoo, zoo_counts = zoo_phase(args.zoo_steps, ZOO["seeds"], cpu["zoo"])
        for k, v in zoo_counts.items():
            counts[k] += v
        lap("8 zoo")
        if args.figure_steps is not None:
            log("figures", cut=f"steps {args.figure_steps} of the drivers' reduced 4500 "
                               "(fig9_zoo keeps its own); seeds, widths and event times uncut")
        figures, figure_counts = figure_phase(
            args.figure_steps, os.path.join(ROOT, "chiprun_out", "figures_smoke"), cpu["figures"])
        for k, v in figure_counts.items():
            counts[k] += v
        lap("9 figures")
        if args.rwsgd_steps < RWSGD["steps"]:
            log("rwsgd", cut=f"steps {args.rwsgd_steps} of the example's {RWSGD['steps']}; "
                             "widths, depth and seeds uncut")
        payload, payload_counts = payload_phase(
            args.rwsgd_steps, RWSGD["seeds"], cpu["rwsgd"],
            os.path.join(ROOT, "chiprun_out", "figures_smoke"))
        for k, v in payload_counts.items():
            counts[k] += v
        lap("10 payload")
        durable, counts_11 = durable_phase(graph, args.steps, main_res["decafork"])
        main_res["decafork"].pop("outs")
        counts["whole_round"] += counts_11
        lap("11 durable")
        sharded = sharded_phase()
        lap("12 sharded")
        # phases 3-11's cache slots are done with; phase 15's state needs the room
        plan_mod.clear_cache()
        gc.collect()
        torch.cuda.empty_cache()
        large, counts_15 = large_graph_phase(cpu["large"])
        counts["whole_round"] += counts_15
        lap("15 large graph")
    finally:
        pool.terminate()
        pool.join()
    families, family_counts = families_phase("cuda")
    for k, v in family_counts.items():
        counts[k] += v
    lap("13 families")
    log("time", **{k.replace(" ", "_"): f"{v:.1f}" for k, v in phase_s.items()})

    for r in rows:
        r["launches"] = counts.get(r["name"], 0)
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was never launched on its path")
    log("launches", **{k.__name__: counts[k.__name__] for k in KERNELS})

    detail = dict(nvidia_smi=smi, device=name, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  build_s_by_source=build, sass=sass, kernels=rows,
                  main=main_res, profile=profile, parity=parity, unfused=unfused,
                  captured_vs_eager=captured, serve=serve, sweep=sweep, zoo=zoo,
                  figures=figures, payload=payload, durable=durable, sharded=sharded,
                  large_graph=large, families=families, train=training, phase_s=phase_s)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(detail, fh, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
