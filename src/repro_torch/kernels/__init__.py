"""Hand-written Hopper kernels (CUDA C++, sm_90a).

  whole_round     — one whole round, ``round_impl="fused"`` (csrc/whole_round.cu)
  round_update    — the observation pass, ``estimator_impl="fused"`` (csrc/round_update.cu)
  theta_sums      — the per-node estimator sweep, ``estimator_impl="pallas"`` (csrc/theta_sums.cu)
  flash_attention — causal / windowed GQA attention, the dense prefill with
                    ``cfg.use_pallas`` (csrc/flash_attention.cu)
  ssd_intra_chunk — the Mamba-2 intra-chunk block, the SSM prefill with
                    ``cfg.use_pallas`` (csrc/ssd_intra_chunk_sm90.cu for
                    bf16 B / C, csrc/ssd_intra_chunk.cu for f32)

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its kernel on CUDA tensors, counting launches in ``<wrapper>.launches``.
The kernels are built with nvcc at first use (``_build``).
"""
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.ops import attention_pallas, ssd_pallas
from repro_torch.kernels.round_update import (
    round_update,
    round_update_plain,
    whole_round,
    whole_round_plain,
)
from repro_torch.kernels.ssd_scan import ssd_intra_chunk, ssd_intra_chunk_plain
from repro_torch.kernels.theta_survival import theta_sums, theta_sums_plain

KERNELS = (whole_round, round_update, theta_sums, flash_attention, ssd_intra_chunk)

__all__ = [
    "KERNELS",
    "attention_pallas",
    "flash_attention",
    "flash_attention_plain",
    "round_update",
    "round_update_plain",
    "ssd_intra_chunk",
    "ssd_intra_chunk_plain",
    "ssd_pallas",
    "theta_sums",
    "theta_sums_plain",
    "whole_round",
    "whole_round_plain",
]
