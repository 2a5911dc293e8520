"""Architecture registry: HF `architectures` string -> config class."""
from __future__ import annotations

from functools import lru_cache


@lru_cache
def get_architectures() -> dict:
    from . import deepseek, deepseek_v4, gemma, llama, moe

    return {cls.arch_string: {"config_class": cls}
            for cls in (llama.LlamaConfig, llama.MistralConfig, llama.Qwen2Config,
                        llama.Qwen3Config, moe.MixtralConfig, moe.Qwen3MoeConfig,
                        deepseek.DeepseekV3Config, deepseek.DeepseekV2Config,
                        deepseek.DeepseekV1Config, deepseek_v4.DeepseekV4Config,
                        gemma.Gemma2Config, gemma.Gemma3Config)}
