"""Architecture registry: HF `architectures` string -> config class."""
from __future__ import annotations

from functools import lru_cache


@lru_cache
def get_architectures() -> dict:
    from . import llama, moe

    return {cls.arch_string: {"config_class": cls}
            for cls in (llama.LlamaConfig, llama.MistralConfig, llama.Qwen2Config,
                        llama.Qwen3Config, moe.MixtralConfig, moe.Qwen3MoeConfig)}
