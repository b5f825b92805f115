"""Model zoo of the port: the video DiT, the causal LLM and their attention backends."""

from sageattention_tpu_torch.models.attention import (
    SageAttnProcessor,
    attention,
    get_attention_backend,
    register_backend,
    set_attention_backend,
    set_mesh,
)
from sageattention_tpu_torch.models.configs import MODEL_CONFIGS, DiTConfig, LLMConfig
from sageattention_tpu_torch.models.dit import VideoDiT
from sageattention_tpu_torch.models.llm import CausalLM

__all__ = [
    "attention",
    "register_backend",
    "set_attention_backend",
    "get_attention_backend",
    "set_mesh",
    "SageAttnProcessor",
    "MODEL_CONFIGS",
    "DiTConfig",
    "LLMConfig",
    "VideoDiT",
    "CausalLM",
]
