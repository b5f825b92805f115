"""Model zoo of the port: the video DiTs (joint, dual-stream, cross-attention), the causal
LLM and their attention backends."""

from sageattention_tpu_torch.models.attention import (
    SageAttnProcessor,
    attention,
    get_attention_backend,
    register_backend,
    sage_attention_fn,
    set_attention_backend,
    set_mesh,
)
from sageattention_tpu_torch.models.configs import MODEL_CONFIGS, DiTConfig, LLMConfig
from sageattention_tpu_torch.models.dit import VideoDiT
from sageattention_tpu_torch.models.llm import CausalLM
from sageattention_tpu_torch.models.mmdit import CrossAttnVideoDiT, DualStreamVideoDiT

__all__ = [
    "attention",
    "register_backend",
    "set_attention_backend",
    "get_attention_backend",
    "set_mesh",
    "SageAttnProcessor",
    "sage_attention_fn",
    "MODEL_CONFIGS",
    "DiTConfig",
    "LLMConfig",
    "VideoDiT",
    "CausalLM",
    "DualStreamVideoDiT",
    "CrossAttnVideoDiT",
]
