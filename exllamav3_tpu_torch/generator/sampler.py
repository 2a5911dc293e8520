"""Sampler settings (counterpart of exllamav3_tpu/generator/sampler.py).

A Sampler is a tuple of step settings; the generator turns a batch of them
into per-row parameter tensors (batch_sampler.py) and samples every row in
one pass. Ported steps: temperature, top-k, top-p, min-p, repetition and
presence/frequency penalties. XTC, adaptive-p, logit bias and token bans
wait.
"""
from __future__ import annotations

from dataclasses import dataclass

NEG_INF = -1e30


@dataclass(frozen=True)
class SS_Temperature:
    temperature: float = 1.0


@dataclass(frozen=True)
class SS_TopK:
    top_k: int = 50


@dataclass(frozen=True)
class SS_TopP:
    top_p: float = 1.0


@dataclass(frozen=True)
class SS_MinP:
    min_p: float = 0.0


@dataclass(frozen=True)
class SS_RepP:
    """Repetition penalty (divisive, HF style) over seen-token counts."""

    rep_p: float = 1.0


@dataclass(frozen=True)
class SS_PresFreqP:
    """Additive presence/frequency penalties."""

    presence_p: float = 0.0
    frequency_p: float = 0.0


@dataclass(frozen=True)
class Sampler:
    steps: tuple = ()
    greedy: bool = False


def GreedySampler() -> Sampler:
    return Sampler(steps=(), greedy=True)


def CustomSampler(temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0, rep_p: float = 1.0, presence_p: float = 0.0,
                  frequency_p: float = 0.0) -> Sampler:
    steps: list = []
    if rep_p != 1.0:
        steps.append(SS_RepP(rep_p))
    if presence_p or frequency_p:
        steps.append(SS_PresFreqP(presence_p, frequency_p))
    if temperature != 1.0:
        steps.append(SS_Temperature(temperature))
    if top_k:
        steps.append(SS_TopK(top_k))
    if top_p < 1.0:
        steps.append(SS_TopP(top_p))
    if min_p > 0.0:
        steps.append(SS_MinP(min_p))
    return Sampler(steps=tuple(steps))


def DefaultSampler(temperature: float = 0.8, min_p: float = 0.08, rep_p: float = 1.01) -> Sampler:
    return CustomSampler(temperature=temperature, min_p=min_p, rep_p=rep_p)
