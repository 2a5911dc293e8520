"""Token embedding (counterpart of exllamav3_tpu/modules/embedding.py; the
multimodal substitution waits)."""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module


class Embedding(Module):
    def __init__(self, config, key: str, vocab_size: int, hidden_size: int):
        super().__init__(config, key)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size

    def load(self, params: dict, device: torch.device) -> None:
        w = self.config.stc.get_tensor(self.key + ".weight")
        params[self.key] = {"weight": w.to(torch.float32).to(device=device, dtype=torch.bfloat16)}

    def forward(self, ids, params: dict, ctx: ForwardCtx):
        return params[self.key]["weight"][ids]
