"""Token embedding (counterpart of exllamav3_tpu/modules/embedding.py; the
multimodal substitution waits). `scale` multiplies the looked-up rows in f32
before the bf16 round, as the JAX package does (Gemma: sqrt(hidden); HF
rounds the factor to bf16 first, about 3e-3 relative apart at h = 5376)."""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module


class Embedding(Module):
    def __init__(self, config, key: str, vocab_size: int, hidden_size: int,
                 scale: float = 1.0):
        super().__init__(config, key)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.scale = scale

    def load(self, params: dict, device: torch.device) -> None:
        w = self.config.stc.get_tensor(self.key + ".weight")
        params[self.key] = {"weight": w.to(torch.float32).to(device=device, dtype=torch.bfloat16)}

    def forward(self, ids, params: dict, ctx: ForwardCtx):
        x = params[self.key]["weight"][ids]
        if self.scale != 1.0:
            x = (x.to(torch.float32) * self.scale).to(x.dtype)
        return x
