"""Model families served by the port: config, layers, SSM, MoE and MLA,
decoder blocks and the ``Model`` API (every family of the registry)."""
from repro_torch.models.config import ARCH_TYPES, ModelConfig
from repro_torch.models.model import Model, ModelParams, batch_spec

__all__ = ["ARCH_TYPES", "Model", "ModelConfig", "ModelParams", "batch_spec"]
