"""Generator: continuous batching over a paged KV cache
(counterpart of exllamav3_tpu/generator/generator.py, core only).

Each iteration admits queued jobs, spends one token budget (max_chunk_size)
on chunked prefill across the prefilling jobs, and runs one batched decode
step for every running job. Complete pages register by content hash so a
later prompt with the same prefix reuses them. Every active job owns a slot
row in the per-slot token counts that feed the repetition penalties.

PyTorch runs eagerly, so the JAX package's shape buckets (which only limit
recompiles) are gone: a step runs exactly the rows and tokens it has. Each
block table carries one extra column pointing at scratch page 0. The cache
may be quantized (CacheSpec.k_bits / v_bits / compand_a): `Model.forward`
reads the widths from the cache's spec at every step, and prefix reuse works
on page numbers, whatever arrays a layer's state holds.

Not ported yet: speculative decoding (draft, n-gram, MTP, DFlash), filters,
CFG, token healing, banned and stop strings, requeue, the CPU page cache,
defragmentation, decode bursts, recurrent state, sequence parallelism,
multihost and the tokenizer: this generator takes and returns token ids.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import PAGE_SIZE
from .batch_sampler import BatchSamplerParams, batch_sample
from .job import Job
from .pagetable import PageTable, _page_hash


class Generator:
    def __init__(self, model, cache, max_batch_size: int = 32, max_chunk_size: int = 2048,
                 seed: int = 0):
        if cache.spec.layout != "paged":
            raise ValueError("Generator requires a paged cache")
        self.model = model
        self.cache = cache
        self.device = model.device
        self.max_batch_size = max_batch_size
        self.max_chunk_size = max_chunk_size
        self.pagetable = PageTable(cache.spec.num_pages)
        self.pending: list[Job] = []
        self.active: list[Job] = []
        self.job_slots: dict = {}
        self.free_slots = list(range(max_batch_size))
        # +1 scrap row
        self.token_counts = torch.zeros((max_batch_size + 1, model.config.vocab_size),
                                        dtype=torch.int32, device=self.device)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed)

    # -- public API ------------------------------------------------------

    def enqueue(self, job: Job | list):
        jobs = job if isinstance(job, list) else [job]
        for j in jobs:
            j.time_enqueued = time.time()
            j.status = "queued"
            self.pending.append(j)
        return [j.identifier for j in jobs]

    def num_remaining_jobs(self) -> int:
        return len(self.pending) + len(self.active)

    def generate(self, prompt_ids, max_new_tokens=128, sampler=None, stop_conditions=None):
        """Blocking convenience: prompt(s) -> generated token ids."""
        single = not isinstance(prompt_ids, list)
        prompts = [prompt_ids] if single else prompt_ids
        jobs = [Job(p, max_new_tokens=max_new_tokens, sampler=sampler,
                    stop_conditions=stop_conditions) for p in prompts]
        order = {j.identifier: i for i, j in enumerate(jobs)}
        self.enqueue(jobs)
        tokens: list = [None] * len(jobs)
        while self.num_remaining_jobs():
            for r in self.iterate():
                i = order.get(r["identifier"])
                if i is not None and r["stage"] == "finished":
                    tokens[i] = r["new_tokens"]
        return tokens[0] if single else tokens

    # -- scheduling ----------------------------------------------------------

    def iterate(self) -> list:
        """Run one generator iteration; returns the result events."""
        results: list = []
        self._admit_jobs(results)
        # prefilling jobs share one token budget per iteration, so a long
        # prompt starves neither other prompts nor decode
        budget = self.max_chunk_size
        for job in [j for j in self.active if j.status == "prefill"]:
            if budget <= 0:
                break
            budget -= self._prefill_job(job, results, budget)
        running = [j for j in self.active if j.status == "running"]
        if running:
            self._decode_batch(running, results)
        return results

    def _admit_jobs(self, results: list):
        while self.pending and self.free_slots:
            job = self.pending[0]
            if job.pages_needed() + 1 > self.pagetable.num_pages - 1:
                self.pending.pop(0)
                job.status = "finished"
                job.eos_reason = "too_long"
                results.append({"identifier": job.identifier, "stage": "finished",
                                "job": job, "eos_reason": "too_long", "new_tokens": []})
                continue
            alloc = self.pagetable.allocate_sequence(job.all_ids())
            if alloc is None:
                break  # no pages free
            self.pending.pop(0)
            job.pages, job.cached_tokens = alloc
            job.prefill_done = min(job.cached_tokens, job.seq_len - 1)
            job.page_hashes = self._hash_chain(job)
            job.status = "prefill"
            job.time_prefill_start = time.time()
            self.active.append(job)
            slot = self.free_slots.pop(0)
            self.job_slots[job] = slot
            # seed the penalty counts from the prompt
            counts = np.zeros(self.model.config.vocab_size, dtype=np.int32)
            np.add.at(counts, job.all_ids() % counts.size, 1)
            self.token_counts[slot] = torch.from_numpy(counts).to(self.device)
            results.append({"identifier": job.identifier, "stage": "started", "job": job,
                            "cached_tokens": job.cached_tokens})

    def _hash_chain(self, job: Job):
        hashes: list = []
        prev = None
        ids = job.all_ids()
        for pi in range(len(job.pages)):
            a, b = pi * PAGE_SIZE, min((pi + 1) * PAGE_SIZE, len(ids))
            if b - a == PAGE_SIZE:
                prev = _page_hash(prev, ids[a:b])
                hashes.append(prev)
            else:
                hashes.append(None)
        return hashes

    def _block_tables(self, page_lists: list) -> np.ndarray:
        """(B, max pages + 1) int32; unused columns and the extra last column
        point at scratch page 0."""
        bt = np.zeros((len(page_lists), max(len(p) for p in page_lists) + 1), np.int32)
        for i, pages in enumerate(page_lists):
            bt[i, : len(pages)] = pages
        return bt

    # -- prefill -----------------------------------------------------------------

    def _prefill_job(self, job: Job, results: list, budget: int) -> int:
        """Prefill up to min(budget, max_chunk_size) tokens of the prompt and
        return the count. All but the last prompt token go through prefill;
        the first decode step feeds the last one and samples from its logits."""
        ids = job.all_ids()
        end = len(ids) - 1
        start = job.prefill_done
        chunk = min(self.max_chunk_size, end - start, budget)
        if chunk > 0:
            pos = np.arange(start, start + chunk, dtype=np.int32)[None]
            self.model.forward(ids[None, start: start + chunk], self.cache, pos,
                               np.array([start], np.int32), self._block_tables([job.pages]))
            job.prefill_done = start + chunk
        if job.prefill_done >= end:
            job.status = "running"
            job.time_prefill_end = time.time()
            self._finalize_full_pages(job, upto=end)
        results.append({"identifier": job.identifier, "stage": "prefill", "job": job,
                        "curr_progress": job.prefill_done, "max_progress": end})
        return max(chunk, 0)

    def _finalize_full_pages(self, job: Job, upto: int):
        """Register pages fully written by prefill for prefix reuse."""
        prev = None
        for pi in range(len(job.pages)):
            a, b = pi * PAGE_SIZE, (pi + 1) * PAGE_SIZE
            if b > upto:
                break
            if job.page_hashes[pi] is not None:
                self.pagetable.finalize_page(job.pages[pi], prev, job.input_ids[a:b])
                prev = job.page_hashes[pi]

    # -- decode --------------------------------------------------------------------

    def _decode_batch(self, jobs: list, results: list):
        for job in list(jobs):  # grow pages for jobs crossing a page boundary
            while job.pages_needed() > len(job.pages):
                newp = self.pagetable.extend_sequence()
                if newp is None:
                    self._finish_job(job, "cache_overflow", results)
                    jobs.remove(job)
                    break
                job.pages.append(newp)
                job.page_hashes.append(None)
        if not jobs:
            return
        B = len(jobs)
        ids = np.array([[j.new_tokens[-1] if j.new_tokens else j.input_ids[-1]] for j in jobs],
                       np.int64)
        seqlens = np.array([j.seq_len - 1 for j in jobs], np.int32)
        slots = torch.tensor([self.job_slots[j] for j in jobs], device=self.device)
        logits = self.model.forward(ids, self.cache, seqlens[:, None], seqlens,
                                    self._block_tables([j.pages for j in jobs]))
        sp = BatchSamplerParams.from_samplers([j.sampler for j in jobs]).as_device(self.device)
        toks = batch_sample(logits[:, -1], sp, self.token_counts[slots], self.rng)
        self.token_counts.index_put_((slots, toks),
                                     torch.ones(B, dtype=torch.int32, device=self.device),
                                     accumulate=True)
        for job, tok in zip(jobs, toks.tolist()):
            self._receive_token(job, tok, results)

    def _receive_token(self, job: Job, tok: int, results: list):
        now = time.time()
        if not job.new_tokens:
            job.time_first_token = now
        job.time_last_token = now
        job.new_tokens.append(tok)
        self._maybe_finalize_decode_page(job)
        if tok in job.stop_tokens:
            job.new_tokens.pop()  # the stop token is not part of the output
            self._finish_job(job, "stop_token", results)
            return
        results.append({"identifier": job.identifier, "stage": "streaming", "job": job,
                        "token_ids": [tok]})
        if len(job.new_tokens) >= job.max_new_tokens:
            self._finish_job(job, "max_new_tokens", results)

    def _maybe_finalize_decode_page(self, job: Job):
        n = job.seq_len
        if n % PAGE_SIZE == 0:
            pi = n // PAGE_SIZE - 1
            prev = job.page_hashes[pi - 1] if pi > 0 else None
            if prev is not None or pi == 0:
                page_ids = job.all_ids()[pi * PAGE_SIZE: (pi + 1) * PAGE_SIZE]
                job.page_hashes[pi] = _page_hash(prev, page_ids)
                self.pagetable.finalize_page(job.pages[pi], prev, page_ids)

    def _finish_job(self, job: Job, reason: str, results: list | None = None):
        job.status = "finished"
        job.eos_reason = reason
        if job in self.active:
            self.active.remove(job)
        self.pagetable.release_sequence(job.pages)
        slot = self.job_slots.pop(job, None)
        if slot is not None:
            self.free_slots.append(slot)
        if results is not None:
            results.append({"identifier": job.identifier, "stage": "finished", "job": job,
                            "eos_reason": reason, "new_tokens": list(job.new_tokens),
                            **job.metrics()})
