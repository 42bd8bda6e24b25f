"""Model configuration covering all six assigned architecture families
(a copy of ``repro.models.config``: the same fields, validation, derived
dims and ``param_count``, so configs carry across unchanged).

One frozen dataclass describes every family; the block and stack code in
``transformer.py`` dispatch on ``arch_type``:

  dense  — pre-norm decoder, GQA attention, SwiGLU MLP (llama lineage)
  moe    — dense skeleton with the MLP swapped for a routed expert layer
           (optionally MLA attention for deepseek-v2)
  ssm    — attention-free Mamba-2 (SSD) blocks
  hybrid — Hymba-style parallel attention + SSM heads in every block
  audio  — dense decoder over EnCodec tokens: K codebooks in, K heads out
  vlm    — dense decoder with M-RoPE and a precomputed-vision-embedding
           prefix (frontend is a stub per the assignment carve-out)
"""
from __future__ import annotations

import dataclasses

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention (num_heads = 0 -> attention-free)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full causal; >0 = window size
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # audio
    num_codebooks: int = 0
    # vlm
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)  # (t, h, w) per half-head-dim
    vision_tokens: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: bool = False
    use_pallas: bool = False
    tie_embeddings: bool = False
    # ---- beyond-paper perf options (EXPERIMENTS.md §Perf) ----
    mla_absorb: bool = False  # absorbed-matmul MLA decode (no K/V remat)
    moe_groups: int = 0  # >0: shard-local MoE dispatch groups (no global sort)
    ssd_chunk: int = 0  # override SSD chunk length (0 -> default 256)
    seq_sharded_residual: bool = False  # Megatron-SP: shard the residual
    # stream's sequence dim over 'model' between blocks (remat-carry /16)

    def __post_init__(self):
        if self.arch_type not in ARCH_TYPES:
            raise ValueError(f"unknown arch_type {self.arch_type!r}")
        if self.arch_type != "ssm" and self.num_heads == 0:
            raise ValueError("attention archs need num_heads")
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    # ---- derived dims ----------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attn_out_dim(self) -> int:
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (matches init; used in reports)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.num_codebooks:
            emb = self.num_codebooks * v * d * 2
        per_layer = 2 * d  # two norms
        if self.arch_type == "ssm":
            per_layer = d  # single pre-norm per mamba block
        # attention
        if self.arch_type != "ssm":
            if self.use_mla:
                r, rr = self.kv_lora_rank, self.rope_head_dim
                qr = self.q_lora_rank or d
                per_layer += d * self.q_lora_rank if self.q_lora_rank else 0
                q_in = self.q_lora_rank if self.q_lora_rank else d
                per_layer += q_in * self.num_heads * (self.head_dim + rr)
                per_layer += d * (r + rr)  # kv down + shared rope key
                per_layer += r * self.num_kv_heads * 2 * self.head_dim
                per_layer += self.num_heads * self.head_dim * d  # o_proj
            elif self.num_heads:
                per_layer += d * self.num_heads * self.head_dim  # q
                per_layer += 2 * d * self.num_kv_heads * self.head_dim  # k,v
                per_layer += self.num_heads * self.head_dim * d  # o
        # mixer: ssm / hybrid extra
        if self.arch_type in ("ssm", "hybrid"):
            di, n, hds = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * n
            per_layer += d * (2 * di + 2 * n + hds)  # in_proj (z,x,B,C,dt)
            per_layer += conv_dim * self.ssm_conv  # conv
            per_layer += 2 * hds + hds  # A_log, D, dt_bias
            per_layer += di * d  # out_proj
        # mlp
        if self.arch_type == "moe":
            e, fe = self.moe_num_experts, self.moe_d_ff
            per_layer += d * e  # router
            per_layer += e * 3 * d * fe
            per_layer += self.moe_num_shared * 3 * d * fe
        elif self.arch_type != "ssm":
            per_layer += 3 * d * f  # swiglu
        total = emb + L * per_layer + d  # final norm
        if self.arch_type == "vlm":
            total += 1024 * d  # vision projector (stub frontend width 1024)
        return int(total)
