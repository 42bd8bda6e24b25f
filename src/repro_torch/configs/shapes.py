"""Assigned input shapes and per-(arch, shape) adjustments (the port's
copy of ``repro.configs.shapes``).

  train_4k     seq_len=4096    global_batch=256   -> train_step
  prefill_32k  seq_len=32768   global_batch=32    -> prefill
  decode_32k   seq_len=32768   global_batch=128   -> serve_step (1 token,
                                                     KV cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     -> serve_step; requires
               sub-quadratic attention: SSM/hybrid run natively, all other
               archs switch to the sliding-window KV-ring variant
               (window 8192; the decode cache's ring, ``_ring_insert``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def adjust_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adjustments: the sliding-window ring for
    ``long_500k`` (every family but ssm; MLA's too, whose decompression is
    O(T)), and ``remat=True`` for training shapes."""
    updates = {}
    if shape.name == "long_500k":
        if cfg.arch_type != "ssm" and cfg.sliding_window == 0:
            updates["sliding_window"] = LONG_CONTEXT_WINDOW
        if cfg.use_mla:
            updates["sliding_window"] = LONG_CONTEXT_WINDOW
    if shape.mode == "train":
        updates["remat"] = True
    return dataclasses.replace(cfg, **updates) if updates else cfg
