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

Greedy speculative decoding: with a draft model (its own linear cache, one
row per job slot) or the n-gram drafter (ngram.py), an iteration in which
every running job is greedy drafts up to num_draft_tokens tokens a job and
verifies them all in one (B, k+1) forward over the paged cache; the output
equals plain greedy decoding wherever the verify's taller forward rounds as a
decode step does (with int8 linears the decode step's MLP is the fused
kernel and the verify's the three-dot path, as in the JAX package, so a
near-tie can part them). Two differences from the JAX package, neither
of which changes a verified token: a draft step writes only the draft-cache
rows of the jobs it drafts for (JAX's steps run every row of the draft cache
and overwrite position 0 of the others), and the running jobs' draft steps
are batched into one (n_jobs, 1) step per drafted token, looped on the host
(JAX scans k steps on the device, one job at a time).

A cache with SWA rings (CacheSpec(swa_ring=True)), and a model with
recurrent layers (`is_recurrent`: DeepSeek-V4's attention, whose ring,
compressor buffers and compressed pools advance destructively), keys
per-sequence state by each job's slot: every forward names its jobs' slot
rows, a slot is cleared when a job takes it (every slot-indexed array; "pos"
to -1, the rest to 0; the page-indexed "pg_*" pools are left alone), and
prefix reuse is off, since a job's state must see every token of its prompt.
The rings hold positions, so a rejected speculative write needs no rewind:
it holds a future position and masks itself. A recurrent layer's state
would need one (the JAX package's _rewind_recurrent, not ported), so
speculative decoding over such a model raises.

Not ported yet: MTP and DFlash drafting, filters (and with them the filtered
half of the speculative verify), CFG, token healing, banned and stop
strings, requeue (and the host stash of a requeued job's ring), the CPU page
cache, defragmentation, decode bursts, speculative rewind of recurrent
state, sequence parallelism, multihost and the tokenizer: this generator
takes and returns token ids.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import PAGE_SIZE
from ..model.cache import Cache, CacheSpec
from .batch_sampler import BatchSamplerParams, batch_sample
from .job import Job
from .ngram import SuffixAutomaton
from .pagetable import PageTable, _page_hash

DRAFT_CHUNK = 128  # tokens a draft-cache catch-up forward takes at most


class Generator:
    def __init__(self, model, cache, max_batch_size: int = 32, max_chunk_size: int = 2048,
                 seed: int = 0, draft_model=None, draft_cache=None, num_draft_tokens: int = 4,
                 use_ngram_draft: bool = False):
        if cache.spec.layout != "paged":
            raise ValueError("Generator requires a paged cache")
        if draft_model is not None and any(draft_model.caps.get(c)
                                           for c in ("dflash_draft", "mtp_draft")):
            raise NotImplementedError("DFlash and MTP drafting are not ported yet")
        self.model = model
        self.cache = cache
        self.device = model.device
        self.max_batch_size = max_batch_size
        self.max_chunk_size = max_chunk_size
        # per-slot state, one row per job slot and a scrap row: recurrent
        # layers' (DeepSeek-V4) and the SWA ring layers'
        self.recurrent_keys = [m.key for m in model.root.walk()
                               if getattr(m, "is_recurrent", False)]
        self.ring_keys = [key for key, layer in cache.state.items()
                          if "pos" in layer and key not in self.recurrent_keys]
        self.has_recurrent = bool(self.recurrent_keys or self.ring_keys)
        if self.recurrent_keys and (draft_model is not None or use_ngram_draft):
            raise NotImplementedError("speculative decoding over a model with recurrent layers "
                                      "needs their state rewound, which is not ported yet")
        if self.has_recurrent:
            first = cache.state[(self.recurrent_keys + self.ring_keys)[0]]
            n_slots = next(t for n, t in first.items() if not n.startswith("pg_")).shape[0]
            if n_slots < max_batch_size + 1:
                raise ValueError(f"the cache has {n_slots} state slots; max_batch_size "
                                 f"{max_batch_size} needs {max_batch_size + 1} "
                                 "(set CacheSpec.recurrent_slots)")
        self.pagetable = PageTable(cache.spec.num_pages, disable_reuse=self.has_recurrent)
        self.pending: list[Job] = []
        self.active: list[Job] = []
        self.job_slots: dict = {}
        self.free_slots = list(range(max_batch_size))
        # +1 scrap row
        self.token_counts = torch.zeros((max_batch_size + 1, model.config.vocab_size),
                                        dtype=torch.int32, device=self.device)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed)
        # speculative decoding: the draft model's linear cache holds one row
        # per job slot, as long as the JAX package makes it
        self.draft_model = draft_model
        self.num_draft_tokens = num_draft_tokens
        self.use_ngram_draft = use_ngram_draft
        self.num_drafted = 0
        self.num_accepted = 0
        if draft_model is not None and draft_cache is None:
            draft_cache = Cache(draft_model, CacheSpec(
                layout="linear", batch_size=max_batch_size,
                max_len=cache.spec.num_pages * PAGE_SIZE // 4))
        if draft_cache is not None and (draft_cache.spec.layout != "linear"
                                        or draft_cache.spec.batch_size < max_batch_size):
            raise ValueError("the draft cache must be linear, with a row per job slot")
        self.draft_cache = draft_cache
        self._draft_done: dict = {}  # job identifier -> tokens in its draft-cache row

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
            if ((self.draft_model is not None or self.use_ngram_draft)
                    and all(j.sampler.greedy for j in running)):
                self._decode_batch_sd(running, results)
            else:
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
            # the slot may hold a finished job's state; "pg_*" pools are page-indexed
            for key in self.recurrent_keys + self.ring_keys:
                for name, t in self.cache.state[key].items():
                    if not name.startswith("pg_"):
                        t[slot] = -1 if name == "pos" else 0
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

    def _state_slots(self, jobs: list) -> np.ndarray | None:
        """(B,) int32 slot rows of `jobs` for per-slot state, else None."""
        if not self.has_recurrent:
            return None
        return np.array([self.job_slots[j] for j in jobs], np.int32)

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
                               np.array([start], np.int32), self._block_tables([job.pages]),
                               state_slots=self._state_slots([job]))
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

    def _grow_pages(self, jobs: list, positions: int, results: list):
        """Pages for `positions` more positions than each job holds tokens;
        a job that finds none finishes with cache_overflow and leaves `jobs`."""
        for job in list(jobs):
            while (job.seq_len + positions + PAGE_SIZE - 1) // PAGE_SIZE > len(job.pages):
                newp = self.pagetable.extend_sequence()
                if newp is None:
                    self._finish_job(job, "cache_overflow", results)
                    jobs.remove(job)
                    break
                job.pages.append(newp)
                job.page_hashes.append(None)

    def _decode_batch(self, jobs: list, results: list):
        self._grow_pages(jobs, 0, results)
        if not jobs:
            return
        B = len(jobs)
        ids = np.array([[j.new_tokens[-1] if j.new_tokens else j.input_ids[-1]] for j in jobs],
                       np.int64)
        seqlens = np.array([j.seq_len - 1 for j in jobs], np.int32)
        slots = torch.tensor([self.job_slots[j] for j in jobs], device=self.device)
        logits = self.model.forward(ids, self.cache, seqlens[:, None], seqlens,
                                    self._block_tables([j.pages for j in jobs]),
                                    state_slots=self._state_slots(jobs))
        sp = BatchSamplerParams.from_samplers([j.sampler for j in jobs]).as_device(self.device)
        toks = batch_sample(logits[:, -1], sp, self.token_counts[slots], self.rng)
        self.token_counts.index_put_((slots, toks),
                                     torch.ones(B, dtype=torch.int32, device=self.device),
                                     accumulate=True)
        for job, tok in zip(jobs, toks.tolist()):
            self._receive_token(job, tok, results)

    # -- speculative decoding -------------------------------------------------------

    def _decode_batch_sd(self, jobs: list, results: list):
        """Greedy speculative decode: draft up to k tokens a job, verify them
        all in one (B, k+1) forward, keep the longest agreeing run and the
        target's next token."""
        k = self.num_draft_tokens
        self._grow_pages(jobs, k + 1, results)  # positions up to seq_len + k
        if not jobs:
            return
        drafts = self._draft_tokens(jobs, k)
        self.num_drafted += sum(len(d) for d in drafts)
        B, S = len(jobs), k + 1
        ids = np.zeros((B, S), np.int64)
        pos = np.zeros((B, S), np.int32)
        seqlens = np.array([j.seq_len - 1 for j in jobs], np.int32)
        for i, job in enumerate(jobs):
            last = job.new_tokens[-1] if job.new_tokens else job.input_ids[-1]
            ids[i, : 1 + len(drafts[i])] = [int(last)] + drafts[i]
            pos[i] = np.arange(seqlens[i], seqlens[i] + S)
        logits = self.model.forward(ids, self.cache, pos, seqlens,
                                    self._block_tables([j.pages for j in jobs]),
                                    state_slots=self._state_slots(jobs))
        out = logits.argmax(dim=-1).cpu().numpy()
        for i, job in enumerate(jobs):
            d = drafts[i]
            accepted = 0
            while accepted < len(d) and out[i, accepted] == d[accepted]:
                accepted += 1
            self.num_accepted += accepted
            job.accepted_draft_tokens += accepted
            job.rejected_draft_tokens += len(d) - accepted
            # the accepted drafts and one token of the target's own, in order
            for tok in out[i, : accepted + 1].tolist():
                if job.status != "running":
                    break
                self._receive_token(job, tok, results)

    def _draft_tokens(self, jobs: list, k: int) -> list:
        """Up to k draft tokens for each job: the n-gram drafter's when it
        finds an earlier occurrence of the job's suffix, else the draft
        model's, else none."""
        drafts: list = [[] for _ in jobs]
        if self.use_ngram_draft:
            for i, job in enumerate(jobs):
                if job.sam is None:
                    job.sam, job.sam_fed = SuffixAutomaton(), 0
                ids = job.all_ids()
                while job.sam_fed < job.seq_len:
                    job.sam.extend(int(ids[job.sam_fed]))
                    job.sam_fed += 1
                drafts[i] = job.sam.draft(k)
        if self.draft_model is not None:
            need = [i for i, d in enumerate(drafts) if not d]
            for i, d in zip(need, self._draft_with_model([jobs[i] for i in need], k)):
                drafts[i] = d
        return drafts

    def _draft_with_model(self, jobs: list, k: int) -> list:
        """Greedy-decode k tokens a job from the draft model over its linear
        cache, whose row of a job is the job's slot. First the row catches up
        on the job's tokens not yet in it (all but the last), in chunks of up
        to DRAFT_CHUNK tokens, the jobs that need a chunk of one length in one
        forward; then k steps of all the jobs together, each feeding back its
        argmax on the device. Positions key the cache, so a rejected draft
        needs no rewind. A job whose context would outgrow its row gets no
        draft tokens."""
        if not jobs:
            return []
        dm, cache = self.draft_model, self.draft_cache
        room = cache.spec.max_len
        drafts: list = [[] for _ in jobs]
        live = [i for i, j in enumerate(jobs) if j.seq_len - 1 + k <= room]
        while True:  # catch up
            by_len: dict = {}
            for i in live:
                job = jobs[i]
                done = self._draft_done.get(job.identifier, 0)
                if done < job.seq_len - 1:
                    by_len.setdefault(min(DRAFT_CHUNK, job.seq_len - 1 - done), []).append(i)
            if not by_len:
                break
            for n, group in by_len.items():
                starts = [self._draft_done.get(jobs[i].identifier, 0) for i in group]
                ids = np.stack([jobs[i].all_ids()[a: a + n] for i, a in zip(group, starts)])
                pos = np.stack([np.arange(a, a + n, dtype=np.int32) for a in starts])
                dm.forward(ids, cache, pos, np.array(starts, np.int32),
                           cache_rows=np.array([self.job_slots[jobs[i]] for i in group], np.int32))
                for i, a in zip(group, starts):
                    self._draft_done[jobs[i].identifier] = a + n
        if not live:
            return drafts
        dev = dm.device
        rows = torch.tensor([self.job_slots[jobs[i]] for i in live], dtype=torch.int32, device=dev)
        tok = torch.tensor([[int(jobs[i].all_ids()[-1])] for i in live], device=dev)
        t = torch.tensor([jobs[i].seq_len - 1 for i in live], dtype=torch.int32, device=dev)
        steps = []
        for _ in range(k):
            logits = dm.forward(tok, cache, t[:, None], t, cache_rows=rows)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            steps.append(tok)
            t = t + 1
        out = torch.cat(steps, dim=1).cpu().tolist()
        for i, d in zip(live, out):
            drafts[i] = d
            self._draft_done[jobs[i].identifier] = jobs[i].seq_len - 1
        return drafts

    def _receive_token(self, job: Job, tok: int, results: list):
        now = time.time()
        if not job.new_tokens:
            job.time_first_token = now
        job.time_last_token = now
        # the forward that sampled `tok` wrote the K/V of the token before it
        self._maybe_finalize_decode_page(job)
        job.new_tokens.append(tok)
        if tok in job.stop_tokens:
            job.new_tokens.pop()  # the stop token is not part of the output
            self._finish_job(job, "stop_token", results)
            return
        results.append({"identifier": job.identifier, "stage": "streaming", "job": job,
                        "token_ids": [tok]})
        if len(job.new_tokens) >= job.max_new_tokens:
            self._finish_job(job, "max_new_tokens", results)

    def _maybe_finalize_decode_page(self, job: Job):
        """Register the page that the job's last token completed, once a
        forward has written that token's K/V: called before the job receives
        the token that forward sampled. A page completed by a job's final
        token is never written and never registered (the JAX package
        registers it at once, and a later prompt may then reuse a page whose
        last slot holds no K/V)."""
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
        self._draft_done.pop(job.identifier, None)
        if results is not None:
            results.append({"identifier": job.identifier, "stage": "finished", "job": job,
                            "eos_reason": reason, "new_tokens": list(job.new_tokens),
                            **job.metrics()})
