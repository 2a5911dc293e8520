"""Job: one generation request (counterpart of exllamav3_tpu/generator/job.py).

The port's generator takes token ids and returns token ids; stop strings,
filters, banned strings, healing, CFG and multimodal payloads wait with the
tokenizer.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..constants import PAGE_SIZE
from .sampler import GreedySampler, Sampler

_serial = itertools.count()


class Job:
    def __init__(self, input_ids, max_new_tokens: int = 256, sampler: Sampler | None = None,
                 stop_conditions: list | None = None, identifier=None):
        ids = np.asarray(input_ids).reshape(-1).astype(np.int64)
        if ids.size == 0:
            raise ValueError("empty prompt")
        self.input_ids = ids
        self.max_new_tokens = max_new_tokens
        self.sampler = sampler or GreedySampler()
        self.identifier = identifier if identifier is not None else next(_serial)
        self.stop_tokens: set[int] = set()
        for sc in stop_conditions or []:
            if isinstance(sc, str):
                raise ValueError("stop strings need the tokenizer, which is not ported yet")
            self.stop_tokens.add(int(sc))

        # runtime state, owned by the generator
        self.status = "queued"  # queued | prefill | running | finished
        self.pages: list[int] = []
        self.page_hashes: list[bytes | None] = []
        self.cached_tokens = 0
        self.prefill_done = 0  # tokens whose KV is in the cache
        self.new_tokens: list[int] = []
        self.eos_reason: str | None = None
        self.time_enqueued = 0.0
        self.time_prefill_start = 0.0
        self.time_prefill_end = 0.0
        self.time_first_token = 0.0
        self.time_last_token = 0.0

    def metrics(self) -> dict:
        """Per-job serving metrics attached to the finished event."""
        t_gen = max(self.time_last_token - self.time_prefill_end, 0.0)
        n = len(self.new_tokens)
        return {
            "prompt_tokens": int(self.input_ids.size),
            "cached_tokens": int(self.cached_tokens),
            "generated_tokens": n,
            "time_enqueued": self.time_enqueued,
            "queued_s": max(self.time_prefill_start - self.time_enqueued, 0.0),
            "prefill_s": max(self.time_prefill_end - self.time_prefill_start, 0.0),
            "ttft_s": max(self.time_first_token - self.time_enqueued, 0.0),
            "generate_s": t_gen,
            "generate_tok_s": (n / t_gen) if t_gen > 0 else 0.0,
        }

    @property
    def seq_len(self) -> int:
        return int(self.input_ids.size) + len(self.new_tokens)

    def all_ids(self) -> np.ndarray:
        if not self.new_tokens:
            return self.input_ids
        return np.concatenate([self.input_ids, np.asarray(self.new_tokens, dtype=np.int64)])

    def pages_needed(self) -> int:
        return (self.seq_len + PAGE_SIZE - 1) // PAGE_SIZE
