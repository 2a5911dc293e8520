"""The compiled decode step: the JAX generator's `_get_decode_fn` and
`_get_burst_fn` (exllamav3_tpu/generator/generator.py) for PyTorch, where a
compiled dispatch is a CUDA graph.

One step is the model's forward over the paged cache, `batch_sample`, the
count update of the sampled tokens in the generator's `token_counts`, and the
feedback: the sampled ids become the next step's ids, positions and cache
lengths advance by one, and the ids land in an (n_max, B) output at a step
index held on the device. A burst of n steps is n runs of that step with no
host read between them; the host reads the (n, B) ids once, at its end.

The step runs on static tensors: ids, positions, cache lengths, state
slots, the rows' sampler settings and the block tables (B, MP + 1), all
int32 words of one device buffer that the host fills with one copy from
pinned memory before a burst.

With `capture` (CUDA), a batch whose bucket holds at most `max_rows` rows (a
model's `graph_decode_rows`: from 16 rows the MoE layers' grouped path reads
the device on the host) runs on padded shapes, one set of static tensors and
one graph for each (batch bucket, table bucket). Batches pad to the JAX
package's buckets 1, 2, 4, 8, 16, 32, 64, capped at max_batch_size; block
tables to a power of two of pages and the extra scratch column (the JAX
package's 4, 16, 64, ... would size the split-key decode kernel for up to 4x
the keys: `decode_split_keys` reads the table's width). A padded row is what
the JAX package pads with: token 0, a table of scratch page 0, cache length
0, a position in the table's last column, the scrap slot max_batch_size,
and no count update; it sees no key of any real row, and every kernel
computes a row from that row alone. The first burst at a bucket runs its
first step eagerly, which warms up every lazy thing the step touches (the
kernels' one-time attributes, the sizes of the shared scratch and arrival
counters, per-device tables), then captures the step into a
`torch.cuda.CUDAGraph`; every later step at that bucket is a replay. One
graph a bucket, not one a burst length. All graphs share one private memory
pool (they replay one at a time), each keeps the workspace buffers it was
captured over (util/device.py::workspace_buffers), and each has the
generator's torch.Generator registered, so that a replay draws new noise. A
replay runs no Python, so the kernels' wrappers count nothing: the launches
each counted during the capture are added to it on every replay
(ops/launches.py). A failed capture or replay raises; nothing falls back to
the eager step.

Every other step (the CPU's, a model's that reads the device on the host
during a decode step, a batch above `max_rows`) runs eagerly at its exact
rows and table width, as a single step does. With `pad` an eager step takes
the padded shapes too (the eager side of a comparison with a replay).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import PAGE_SIZE
from ..ops.launches import add_counts, counts_since, read_counts, set_counts
from ..util.device import workspace_buffers
from .batch_sampler import BatchSamplerParams, batch_sample

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# the per-row int32 words of a bucket's buffer, in order; the block table follows
_INTS = ("ids", "pos", "seqlens", "slots", "real", "top_k", "greedy")
_FLOATS = ("temperature", "top_p", "min_p", "rep_p", "presence_p", "frequency_p")


def batch_buckets(max_batch_size: int) -> list:
    """The JAX package's batch buckets, capped at max_batch_size."""
    return sorted({min(b, max_batch_size) for b in BATCH_BUCKETS})


def bucket(n: int, buckets) -> int:
    """The first bucket that holds n, else the last (the JAX package's _bucket)."""
    return next((b for b in buckets if n <= b), buckets[-1])


def pages_bucket(n: int) -> int:
    """Pages a block table holds for a batch whose longest row has n: the
    next power of two (the table has one more column, scratch page 0)."""
    return 1 << max(n - 1, 0).bit_length()


class _Bucket:
    """The static tensors of one (B, MP) shape, and its graph where captured."""

    def __init__(self, B: int, MP: int, n_max: int, vocab: int, device, keep_logits: bool):
        self.B, self.MP = B, MP
        width = B * (len(_INTS) + len(_FLOATS) + MP + 1)
        self.host = torch.zeros(width, dtype=torch.int32, pin_memory=device.type == "cuda")
        self.dev = torch.zeros(width, dtype=torch.int32, device=device)
        words = self.host.numpy()
        self.h, self.d = {}, {}
        for i, name in enumerate(_INTS + _FLOATS):
            self.h[name] = words[i * B: (i + 1) * B]
            self.d[name] = self.dev[i * B: (i + 1) * B]
            if name in _FLOATS:
                self.h[name] = self.h[name].view(np.float32)
                self.d[name] = self.d[name].view(torch.float32)
        o = (len(_INTS) + len(_FLOATS)) * B
        self.h["bt"] = words[o:].reshape(B, MP + 1)
        self.d["bt"] = self.dev[o:].view(B, MP + 1)
        self.out = torch.zeros((n_max, B), dtype=torch.int64, device=device)
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.logits = (torch.zeros((B, vocab), dtype=torch.float32, device=device)
                       if keep_logits else None)
        self.graph = None
        self.counts: dict = {}  # launches a replay adds
        self.keep: list = []    # workspace buffers the graph was captured over


class DecodeGraph:
    """The decode step of one generator, eager or captured per bucket.

    `token_counts` (max_batch_size + 1, V) int32 and `rng` are the
    generator's; `state_slots` says whether the model keeps per-sequence
    state by slot (SWA rings, recurrent layers). `keep_logits` also copies
    each step's last logits into the bucket's `logits` (for comparisons)."""

    def __init__(self, model, cache, token_counts: torch.Tensor, rng: torch.Generator,
                 max_batch_size: int, n_max: int, capture: bool, state_slots: bool = False,
                 keep_logits: bool = False, max_rows: int | None = None, pad: bool = False):
        if capture and model.device.type != "cuda":
            raise ValueError("DecodeGraph: capture needs a CUDA model")
        self.model, self.cache = model, cache
        self.token_counts, self.rng = token_counts, rng
        self.max_batch_size = max_batch_size
        self.n_max = n_max
        self.capture = capture
        self.max_rows = max_rows  # the largest batch bucket captured (None: any)
        self.pad = pad            # pad eager steps to the buckets too
        self.state_slots = state_slots
        self.keep_logits = keep_logits
        self.batch_buckets = batch_buckets(max_batch_size)
        self.buckets: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.steps = 0             # decode steps run on the device, eager and replayed
        self.graphs_captured = 0
        self.capture_s = 0.0
        self.pool_bytes = 0        # device memory the captures reserved
        self.last: _Bucket | None = None  # the bucket of the last run

    def run(self, ids, seqlens, pages, slots, samplers, n: int) -> np.ndarray:
        """n decode steps of len(ids) rows: row i feeds token ids[i] at
        position seqlens[i] over the pages `pages[i]` (which hold every
        position the n steps write), state slot slots[i], sampler
        samplers[i]. Returns the sampled ids (n, rows) int64."""
        if not 1 <= n <= self.n_max:
            raise ValueError(f"DecodeGraph: {n} steps, at most {self.n_max}")
        b = len(ids)
        B = bucket(b, self.batch_buckets)
        if b > B:
            raise ValueError(f"DecodeGraph: {b} rows, at most {B}")
        widest = max(len(p) for p in pages)
        captured = self.capture and (self.max_rows is None or B <= self.max_rows)
        if captured or self.pad:
            MP = pages_bucket(widest)
            s = self.buckets.get((B, MP))
            if s is None:
                s = self.buckets[(B, MP)] = self._bucket(B, MP)
        else:
            s = self._bucket(b, widest)  # the exact shapes
        self._fill(s, ids, seqlens, pages, slots, samplers)
        self.last = s
        first = 0
        if captured and s.graph is None:
            self._step(s)  # the warm-up, and the burst's first step
            self._capture(s)
            first = 1
        for _ in range(first, n):
            if s.graph is None:
                self._step(s)
            else:
                s.graph.replay()
                add_counts(s.counts)
        self.steps += n
        return s.out[:n, :b].cpu().numpy()

    def _bucket(self, B: int, MP: int) -> _Bucket:
        return _Bucket(B, MP, self.n_max, self.token_counts.shape[1], self.model.device,
                       self.keep_logits)

    def _fill(self, s: _Bucket, ids, seqlens, pages, slots, samplers):
        b, B, h = len(ids), s.B, s.h
        s.host.zero_()
        h["ids"][:b] = ids
        h["pos"][:b] = seqlens
        h["pos"][b:] = s.MP * PAGE_SIZE  # the scratch column: a padded row writes page 0
        h["seqlens"][:b] = seqlens
        h["slots"][:b] = slots
        h["slots"][b:] = self.max_batch_size
        h["real"][:b] = 1
        for i, p in enumerate(pages):
            h["bt"][i, : len(p)] = p
        sp = BatchSamplerParams.from_samplers(list(samplers) + [samplers[-1]] * (B - b))
        for name in ("top_k", "greedy") + _FLOATS:
            h[name][:] = getattr(sp, name)
        s.dev.copy_(s.host, non_blocking=True)
        s.step.zero_()

    @torch.no_grad()
    def _step(self, s: _Bucket):
        d, B = s.d, s.B
        logits = self.model.forward(d["ids"].view(B, 1), self.cache, d["pos"].view(B, 1),
                                    d["seqlens"], d["bt"],
                                    state_slots=d["slots"] if self.state_slots else None)
        last = logits[:, -1]
        if s.logits is not None:
            s.logits.copy_(last)
        sp = {name: d[name] for name in ("top_k",) + _FLOATS}
        sp["greedy"] = d["greedy"] != 0
        slots = d["slots"].long()
        toks = batch_sample(last, sp, self.token_counts[slots], self.rng)
        self.token_counts.index_put_((slots, toks), d["real"], accumulate=True)
        s.out.index_copy_(0, s.step, toks[None])
        s.step += 1
        d["ids"].copy_(toks)
        d["pos"] += 1
        d["seqlens"] += 1

    def _capture(self, s: _Bucket):
        """Capture the step at s's bucket; what it launched counts on each
        replay, not now."""
        dev = self.model.device
        before = read_counts()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.rng)
        with torch.cuda.graph(graph, pool=self.pool):
            self._step(s)
        torch.cuda.synchronize(dev)
        self.capture_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        s.counts = counts_since(before)
        set_counts(before)
        s.keep = workspace_buffers()
        s.graph = graph
        self.graphs_captured += 1
