"""Model-family configurations: a copy of the JAX package's
``models/configs.py`` (the port imports nothing of that package).

Reference: example/*.py model choices.

These mirror the architectures the reference accelerates — CogVideoX-2B /
CogVideoX-1.5-5B (example/cogvideox-2b.py, cogvideox1.5-5b.py),
HunyuanVideo (example/hunyuan.py), Mochi-1 (example/mochi.py),
Wan2.1-T2V-1.3B (example/wan.py) — plus an LLM-prefill configuration
(SageAttention's second headline use case).  Dimensions follow the public
model cards; layer counts are the real ones so single-step benchmarks are
representative (use ``scaled(depth=...)`` for smoke tests).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str
    hidden: int
    heads: int
    head_dim: int
    depth: int
    text_len: int
    # video latent geometry: (frames, height, width) after VAE, pre-patch
    latent_frames: int
    latent_height: int
    latent_width: int
    patch: int = 2
    patch_t: int = 1  # temporal patch (CogVideoX-1.5 uses 2)
    mlp_ratio: float = 4.0
    is_causal: bool = False

    @property
    def video_tokens(self) -> int:
        return (
            (self.latent_frames // self.patch_t)
            * (self.latent_height // self.patch)
            * (self.latent_width // self.patch)
        )

    @property
    def seq_len(self) -> int:
        return self.text_len + self.video_tokens

    def scaled(self, **overrides) -> "DiTConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    name: str
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    depth: int
    vocab: int = 32000
    mlp_hidden: int | None = None
    # Mistral/Gemma-style sliding-window attention: each token attends
    # its last `window` positions (prefill: in-kernel band; decode: the
    # cache read is clipped to the window — O(window) per step)
    window: int | None = None

    def scaled(self, **overrides) -> "LLMConfig":
        return dataclasses.replace(self, **overrides)


MODEL_CONFIGS: dict[str, DiTConfig | LLMConfig] = {
    # CogVideoX-2B: 30 layers, 30 heads x 64, hidden 1920, 226 text tokens,
    # 49 frames -> 13 latent frames, 480x720 -> 60x90 latent, patch 2.
    "cogvideox-2b": DiTConfig(
        "cogvideox-2b", 1920, 30, 64, 30, 226, 13, 60, 90
    ),
    # CogVideoX-1.5-5B: 42 layers, 48 heads x 64, hidden 3072 (bf16).
    # The reference example runs 1360x768, 81 frames
    # (example/cogvideox1.5-5b.py) -> latent (22, 96, 170) with temporal
    # patch 2 (the 1.5 transformer's patch_size_t) + spatial patch 2:
    # 11*48*85 = 44880 video tokens.
    "cogvideox1.5-5b": DiTConfig(
        "cogvideox1.5-5b", 3072, 48, 64, 42, 224, 22, 96, 170, patch_t=2
    ),
    # HunyuanVideo: 13B dual-stream; attention shape 24 heads x 128;
    # 720p (1280x720, 33 latent frames) -> latent (33, 90, 160):
    # 33*45*80 = 118800 video tokens.
    "hunyuanvideo": DiTConfig(
        "hunyuanvideo", 3072, 24, 128, 40, 256, 33, 90, 160
    ),
    # Mochi-1: AsymmDiT 10B, 24 heads x 128, 44520 video tokens at 480p.
    "mochi-1": DiTConfig("mochi-1", 3072, 24, 128, 48, 256, 28, 60, 106),
    # Wan2.1-T2V-1.3B: 30 layers, 12 heads x 128, hidden 1536.
    "wan2.1-t2v-1.3b": DiTConfig(
        "wan2.1-t2v-1.3b", 1536, 12, 128, 30, 512, 21, 60, 104
    ),
    # LLM prefill: llama-2-7b-like dense attention (32 x 128, MHA) — the
    # reference's causal bench sweep shape (b=4, h=32, hd=128).
    "llm-7b": LLMConfig("llm-7b", 4096, 32, 32, 128, 32, mlp_hidden=11008),
    # GQA variant (llama-3-8b-like: 32 q heads, 8 kv heads).
    "llm-8b-gqa": LLMConfig(
        "llm-8b-gqa", 4096, 32, 8, 128, 32, vocab=128256, mlp_hidden=14336
    ),
}
