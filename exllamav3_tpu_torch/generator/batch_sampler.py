"""Per-row sampling for the batched decode step
(counterpart of exllamav3_tpu/generator/batch_sampler.py).

Sampler settings become per-row parameter tensors so a heterogeneous batch
samples in one pass. Random draws come from an explicit torch.Generator;
they differ from JAX's stream for the same seed, so sampled paths compare by
statistics, not by tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .sampler import (NEG_INF, Sampler, SS_MinP, SS_PresFreqP, SS_RepP,
                      SS_Temperature, SS_TopK, SS_TopP)

MAX_TOP_K = 256


@dataclass
class BatchSamplerParams:
    """Per-row sampling parameters (host side)."""

    temperature: np.ndarray  # (B,) f32
    top_k: np.ndarray        # (B,) i32, 0 = off
    top_p: np.ndarray        # (B,) f32, 1 = off
    min_p: np.ndarray        # (B,) f32, 0 = off
    rep_p: np.ndarray        # (B,) f32, 1 = off
    presence_p: np.ndarray   # (B,) f32
    frequency_p: np.ndarray  # (B,) f32
    greedy: np.ndarray       # (B,) bool

    @staticmethod
    def from_samplers(samplers: list[Sampler]) -> "BatchSamplerParams":
        B = len(samplers)
        p = BatchSamplerParams(
            temperature=np.ones(B, np.float32), top_k=np.zeros(B, np.int32),
            top_p=np.ones(B, np.float32), min_p=np.zeros(B, np.float32),
            rep_p=np.ones(B, np.float32), presence_p=np.zeros(B, np.float32),
            frequency_p=np.zeros(B, np.float32), greedy=np.zeros(B, bool))
        for i, s in enumerate(samplers):
            p.greedy[i] = s.greedy
            for step in s.steps:
                if isinstance(step, SS_Temperature):
                    p.temperature[i] = step.temperature
                elif isinstance(step, SS_TopK):
                    p.top_k[i] = min(step.top_k, MAX_TOP_K)
                elif isinstance(step, SS_TopP):
                    p.top_p[i] = step.top_p
                elif isinstance(step, SS_MinP):
                    p.min_p[i] = step.min_p
                elif isinstance(step, SS_RepP):
                    p.rep_p[i] = step.rep_p
                elif isinstance(step, SS_PresFreqP):
                    p.presence_p[i] = step.presence_p
                    p.frequency_p[i] = step.frequency_p
                else:
                    raise ValueError(f"sampler step {step!r} is not ported yet")
        return p

    def as_device(self, device) -> dict:
        return {k: torch.as_tensor(v, device=device) for k, v in vars(self).items()}


def batch_sample(logits: torch.Tensor, sp: dict, counts: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """logits (B, V) f32; sp: per-row tensors; counts (B, V) int32 token
    counts. Returns the sampled ids (B,) int64."""
    B, V = logits.shape
    x = logits.to(torch.float32)
    neg = torch.full_like(x, NEG_INF)
    # repetition penalty
    rep = sp["rep_p"][:, None]
    seen = (counts > 0) & (rep != 1.0)
    x = torch.where(seen, torch.where(x > 0, x / rep, x * rep), x)
    # presence / frequency
    cf = counts.to(torch.float32)
    x = x - sp["presence_p"][:, None] * (cf > 0) - sp["frequency_p"][:, None] * cf
    # temperature
    x = x / torch.clamp(sp["temperature"][:, None], min=1e-6)
    # top-k at the largest supported k, thresholded per row
    kmax = min(MAX_TOP_K, V)
    topk_vals = torch.topk(x, kmax, dim=-1).values  # sorted descending
    k = torch.clamp(sp["top_k"].long(), 0, kmax)
    k_thresh = torch.gather(topk_vals, 1, torch.clamp(k - 1, min=0)[:, None])
    x = torch.where((k[:, None] > 0) & (x < k_thresh), neg, x)
    # top-p over the top-k candidates
    probs_sorted = torch.softmax(topk_vals, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep = cum - probs_sorted < sp["top_p"][:, None]
    cut_idx = torch.clamp(keep.sum(dim=-1, keepdim=True) - 1, min=0)
    p_thresh = torch.gather(topk_vals, 1, cut_idx)
    x = torch.where((sp["top_p"][:, None] < 1.0) & (x < p_thresh), neg, x)
    # min-p
    probs = torch.softmax(x, dim=-1)
    mp_thresh = probs.amax(dim=-1, keepdim=True) * sp["min_p"][:, None]
    x = torch.where(probs < mp_thresh, neg, x)
    # Gumbel-argmax sample, or argmax for greedy rows
    u = torch.rand(x.shape, generator=generator, device=x.device).clamp_(min=1e-20)
    noisy = torch.where(x <= NEG_INF / 2, neg, x - torch.log(-torch.log(u)))
    return torch.where(sp["greedy"], x.argmax(dim=-1), noisy.argmax(dim=-1))
