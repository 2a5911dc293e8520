"""DeepSeek-V4 hybrid sparse attention: sliding, CSA and HCA layers
(counterpart of exllamav3_tpu/modules/dsv4_attn.py).

  * MQA with one shared 512-wide kv row a token that is K and V alike: q gets
    an unweighted per-head RMS norm, kv a weighted one, both a GPTJ rope on
    their trailing rope_head_dim dims; the output's rope slice is rotated
    back at the query position afterwards (the paper's eq. 26).
  * Every layer attends over a sliding window of raw rows (128), kept in a
    ring of window + 16 slots a sequence slot; CSA and HCA layers also attend
    over a pool of compressed entries, one every compress_rate positions (4
    for CSA, 128 for HCA), and a per-head sink logit joins the softmax.
  * The compressor (DSV4Compressor) pools each window of m projected rows
    with a softmax gate plus a learned in-window bias (`ape`), RMS-norms the
    pooled row and ropes it at the window start with the compress table. CSA
    overlaps its windows (the previous window's first half and this one's
    second half). Rows of a window still open wait in a position-keyed
    buffer a sequence slot (`cb_*`, `icb_*`).
  * CSA selects pool entries per query with the lightning indexer: its own
    overlapping compressor fills an index pool, and
    score[t, e] = sum_h w[t, h] * relu(q_idx[t, h] . k_idx[e]) / sqrt(Di * Hi)
    picks the top index_topk entries (exact k, ties to the lower index).
  * The output projection is grouped: o_groups groups of heads, each through
    its own wo_a slice (`wo_a.slice.{g}`) to o_lora_rank, concatenated into
    wo_b. A checkpoint with one fused `wo_a` is not read yet.

A decode step (S = 1) over a paged cache writes its row into the ring and
attends the three sources apart through the row 6b kernels
(ops/flash_attention.py: ring_attention_stats; pool_attention_stats over the
HCA pool of 256 / 128 = 2 entries a page, paged through the token block
table; rows_attention_stats over the CSA selection gathered into rows), then
merges their (acc, m, l) with the sinks in one softmax (merge_stats).
Everything else (prefill chunks, a linear cache, cacheless) takes the dense
path in plain torch, in blocks of 256 query rows (the JAX package's default
EXL3_TPU_DSV4_QBLOCK), as the JAX package computes it outside any Pallas
kernel; CSA prefill over a pool wider than twice the selection gathers each
query's selected entries (JAX's default for EXL3_TPU_DSV4_CSA).
The compressor state advances destructively, so the module is recurrent: the
generator keys it by stable slots, clears a slot on admission and reuses no
prefix.
"""
from __future__ import annotations

import math

import torch

from .linear import Linear
from .module import ForwardCtx, Module
from .norms import RMSNorm, rms_norm
from ..constants import PAGE_SIZE
from ..ops.flash_attention import (NEG_INF, merge_stats, pool_attention_stats,
                                   ring_attention_stats, rows_attention_stats)
from ..util.env import dsv4_dense_decode
from ..util.rope import dsv4_inv_freq, gptj_rope_trailing
from .block_sparse_mlp import top_k

QBLOCK = 256  # query rows a block of the dense path: (B, H, QBLOCK, T) score tensors


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, T, C) at rows idx (B, ...) along axis 1 -> (B, ..., C)."""
    flat = idx.reshape(idx.shape[0], -1).long()
    g = torch.gather(t, 1, flat[..., None].expand(-1, -1, t.shape[-1]))
    return g.reshape(*idx.shape, t.shape[-1])


class DSV4Compressor:
    """The window compressor of HCA (width head_dim, windows apart) and of CSA
    and its indexer (width 2 * head_dim, overlapping halves). Owns its
    projections, norm and `ape`; emit() is plain math over one chunk and the
    carried row buffer, whose slot for position p is p % buf_slots."""

    def __init__(self, attn, key: str, head_dim: int, compress_rate: int, overlapping: bool,
                 table: str):
        cfg = attn.config
        self.attn = attn
        self.key = key
        self.head_dim = head_dim
        self.compress_rate = compress_rate
        self.overlapping = overlapping
        self.table = table
        # the previous window, the m rows in flight and speculative headroom
        self.buf_slots = 2 * compress_rate + 32
        self.proj_width = 2 * head_dim if overlapping else head_dim
        self.wkv = Linear(cfg, f"{key}.wkv", attn.hidden_size, self.proj_width)
        self.wgate = Linear(cfg, f"{key}.wgate", attn.hidden_size, self.proj_width)
        self.norm = RMSNorm(cfg, f"{key}.norm", attn.rms_norm_eps, dim=head_dim)
        self.config = cfg

    def modules(self) -> list:
        return [self.wkv, self.wgate, self.norm]

    def load(self, params: dict, device: torch.device) -> None:
        for mod in self.modules():
            mod.load(params, device)
        ape = self.config.stc.get_tensor(f"{self.key}.ape")
        params[self.key] = {"ape": ape.to(torch.float32).to(device)}

    def emit(self, params, x, ctx, p0, end, cbuf_kv, cbuf_gate):
        """One chunk x (B, S, h), valid at positions [p0, end), to complete
        windows. -> (comp (B, E, hd) normed and roped, entry ids (B, E), emit
        (B, E) bool, new buffer kv, new buffer gate); E = S // m + 1. Window
        rows come from [chunk | buffer]; the overlap half of window e is
        window e - 1's first half, from the same gather."""
        m, Rb, hd, pw = self.compress_rate, self.buf_slots, self.head_dim, self.proj_width
        B, S, _ = x.shape
        E = S // m + 1
        dev = x.device
        rows_kv = self.wkv.forward(x, params, ctx).to(torch.float32)
        rows_gate = self.wgate.forward(x, params, ctx).to(torch.float32)

        e_all = (p0 // m)[:, None] + torch.arange(-1, E, device=dev)[None]  # (B, E + 1)
        e = e_all[:, 1:]
        emit = (e + 1) * m <= end[:, None]
        q = e_all[:, :, None] * m + torch.arange(m, device=dev)[None, None]  # (B, E + 1, m)
        t = q - p0[:, None, None]
        from_chunk = (t >= 0)[..., None]
        tc = torch.clamp(t, 0, S - 1)
        bs = torch.clamp(q, min=0) % Rb
        kvw_all = torch.where(from_chunk, _rows(rows_kv, tc), _rows(cbuf_kv, bs))
        gw_all = torch.where(from_chunk, _rows(rows_gate, tc), _rows(cbuf_gate, bs)) \
            + params[self.key]["ape"]
        kvw, gw = kvw_all[:, 1:], gw_all[:, 1:]
        if self.overlapping:
            ok_prev = (e_all[:, :-1] >= 0)[..., None, None]
            prev_kv = torch.where(ok_prev, kvw_all[:, :-1, :, :hd], 0.0)
            prev_g = torch.where(ok_prev, gw_all[:, :-1, :, :hd], NEG_INF)
            kv2 = torch.cat([prev_kv, kvw[..., hd:]], dim=2)
            g2 = torch.cat([prev_g, gw[..., hd:]], dim=2)
        else:
            kv2, g2 = kvw, gw
        comp = (kv2 * torch.softmax(g2, dim=2)).sum(dim=2)                 # (B, E, hd)
        comp = rms_norm(comp, params[self.norm.key]["weight"], self.norm.eps)
        comp = gptj_rope_trailing(comp[:, :, None], self.attn.table(self.table, dev),
                                  e * m)[:, :, 0]

        # the carry: buffer slot i takes the projections of the last valid
        # position congruent to i (mod buf_slots)
        last = end - 1
        q_i = last[:, None] - ((last[:, None] - torch.arange(Rb, device=dev)[None]) % Rb)
        use = (q_i >= p0[:, None])[..., None]
        tb = torch.clamp(q_i - p0[:, None], 0, S - 1)
        nb_kv = torch.where(use, _rows(rows_kv, tb), cbuf_kv)
        nb_gate = torch.where(use, _rows(rows_gate, tb), cbuf_gate)
        return comp, e, emit, nb_kv, nb_gate


class DSV4Attention(Module):
    is_kv_cache_user = True
    # the compressor state advances destructively: stable slots, no prefix
    # reuse, no speculative rewind
    is_recurrent = True
    # a decode step picks the compressed entries it keeps with a nonzero
    # (`keep.nonzero` in _attend_dense), which reads the device on the host: no
    # captured decode step
    graph_decode_rows = 0

    def __init__(self, config, key: str, layer_idx: int, layer_type: str, hidden_size: int,
                 num_q_heads: int, head_dim: int, rope_head_dim: int, q_lora_rank: int,
                 o_groups: int, o_lora_rank: int, sliding_window: int,
                 compress_rate: int | None = None, index_n_heads: int | None = None,
                 index_head_dim: int | None = None, index_topk: int | None = None,
                 rope_theta: float = 10000.0, compress_rope_theta: float = 160000.0,
                 rope_scaling: dict | None = None, rms_norm_eps: float = 1e-6):
        super().__init__(config, key)
        if layer_type not in ("sliding", "csa", "hca"):
            raise ValueError(f"unknown DeepSeek-V4 layer type {layer_type!r}")
        self.layer_idx = layer_idx
        self.layer_type = layer_type
        self.hidden_size = hidden_size
        self.num_q_heads = num_q_heads
        self.head_dim = head_dim
        self.rope_head_dim = rope_head_dim
        self.o_groups = o_groups
        self.o_lora_rank = o_lora_rank
        self.sliding_window = sliding_window
        self.compress_rate = compress_rate
        self.index_n_heads = index_n_heads
        self.index_head_dim = index_head_dim
        self.index_topk = index_topk
        self.rms_norm_eps = rms_norm_eps
        self.sm_scale = head_dim ** -0.5
        # rope tables (f32), and their copies by device
        self._tables = {
            "main": torch.tensor(dsv4_inv_freq(rope_head_dim, rope_theta), dtype=torch.float32),
            "compress": torch.tensor(dsv4_inv_freq(rope_head_dim, compress_rope_theta,
                                                   rope_scaling), dtype=torch.float32)}
        self._on_device: dict = {}

        self.q_a = Linear(config, f"{key}.wq_a", hidden_size, q_lora_rank)
        self.q_norm = RMSNorm(config, f"{key}.q_norm", rms_norm_eps, dim=q_lora_rank)
        self.q_b = Linear(config, f"{key}.wq_b", q_lora_rank, num_q_heads * head_dim)
        self.wkv = Linear(config, f"{key}.wkv", hidden_size, head_dim)
        self.kv_norm = RMSNorm(config, f"{key}.kv_norm", rms_norm_eps, dim=head_dim)
        gw = num_q_heads * head_dim // o_groups
        self.wo_a = [Linear(config, f"{key}.wo_a.slice.{g}", gw, o_lora_rank)
                     for g in range(o_groups)]
        self.wo_b = Linear(config, f"{key}.wo_b", o_groups * o_lora_rank, hidden_size)
        self.compressor = self.indexer = self.idx_wq_b = self.idx_weights = None
        if layer_type != "sliding":
            self.compressor = DSV4Compressor(self, f"{key}.compressor", head_dim, compress_rate,
                                             overlapping=layer_type == "csa", table="compress")
        if layer_type == "csa":
            self.indexer = DSV4Compressor(self, f"{key}.indexer.compressor", index_head_dim,
                                          compress_rate, overlapping=True, table="compress")
            self.idx_wq_b = Linear(config, f"{key}.indexer.wq_b", q_lora_rank,
                                   index_n_heads * index_head_dim)
            self.idx_weights = Linear(config, f"{key}.indexer.weights_proj", hidden_size,
                                      index_n_heads)
        self.own = [m for m in (self.q_a, self.q_norm, self.q_b, self.wkv, self.kv_norm,
                                *self.wo_a, self.wo_b, self.idx_wq_b, self.idx_weights)
                    if m is not None]
        self.compressors = [c for c in (self.compressor, self.indexer) if c is not None]
        self.modules = self.own + [m for c in self.compressors for m in c.modules()]

    def table(self, name: str, device) -> torch.Tensor:
        """The rope table `name` ("main" or "compress") on `device`."""
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = self._tables[name].to(device)
        return self._on_device[key]

    # -- loading ---------------------------------------------------------------

    def load(self, params: dict, device: torch.device) -> None:
        for mod in self.own:
            mod.load(params, device)
        sink = self.config.stc.get_tensor(f"{self.key}.attn_sink", optional=True)
        params[self.key] = {"sinks": (sink.to(torch.float32).to(device) if sink is not None
                                      else torch.zeros(self.num_q_heads, device=device))}
        for comp in self.compressors:
            comp.load(params, device)

    # -- cache -----------------------------------------------------------------

    def new_cache_layer(self, spec, device) -> dict:
        """A state slot's ring ("kv" (n, window + 16, D) bf16 and "pos" (n,
        window + 16) int32, -1 where never written) and compressor buffers
        ("cb_*", "icb_*" f32), and the compressed pools ("pg_pool" (P, epp, D),
        "pg_ipool" (P, epp, index_head_dim) bf16): paged through the token
        block table, epp = 256 / compress_rate entries a page, or linear, one
        row a state slot. "pg_*" arrays are page-indexed, everything else
        slot-indexed; n is CacheSpec.state_slots()."""
        n = spec.state_slots()
        R = self.sliding_window + 16
        D = self.head_dim
        layer = {"kv": torch.zeros((n, R, D), dtype=torch.bfloat16, device=device),
                 "pos": torch.full((n, R), -1, dtype=torch.int32, device=device)}
        if self.compressor is None:
            return layer
        m = self.compress_rate

        def pool(width):
            lead = ((n, max(spec.max_len // m, 1)) if spec.layout == "linear"
                    else (spec.num_pages, PAGE_SIZE // m))
            return torch.zeros((*lead, width), dtype=torch.bfloat16, device=device)

        def buffers(comp):
            return [torch.zeros((n, comp.buf_slots, comp.proj_width), dtype=torch.float32,
                                device=device) for _ in range(2)]

        layer["pg_pool"] = pool(D)
        layer["cb_kv"], layer["cb_gate"] = buffers(self.compressor)
        if self.indexer is not None:
            layer["pg_ipool"] = pool(self.index_head_dim)
            layer["icb_kv"], layer["icb_gate"] = buffers(self.indexer)
        return layer

    # -- forward ---------------------------------------------------------------

    def _slots(self, ctx, B: int, device) -> torch.Tensor:
        if ctx.state_slots is not None:
            return ctx.state_slots.long()
        return torch.arange(B, device=device)

    def _pool_scatter(self, pool, comp, e, emit, ctx, slots):
        """Write the emitted entries into the pool, in place: paged through the
        token block table (entry e in slot e % epp of page bt[b, e // epp]) or
        linear (row slots[b], column e). A decode step's entries lie one a
        sequence on pages of their own, so unemitted ones write back what the
        pool holds; a longer chunk writes only its emitted entries."""
        if ctx.attn_mode == "paged":
            epp = pool.shape[1]
            bt = ctx.block_tables.long()
            rows = torch.gather(bt, 1, torch.clamp(e // epp, max=bt.shape[1] - 1))
            cols = e % epp
        else:
            rows = slots[:, None].expand_as(e)
            cols = torch.clamp(e, max=pool.shape[1] - 1)
        comp = comp.to(pool.dtype)
        if e.shape[1] == 1:
            pool[rows, cols] = torch.where(emit[..., None], comp, pool[rows, cols])
        else:
            b, j = emit.nonzero(as_tuple=True)
            pool[rows[b, j], cols[b, j]] = comp[b, j]

    def _pool_gather(self, pool, ctx, slots) -> torch.Tensor:
        """(B, T, width) entries: every page of the row's block table (paged)
        or the slot's whole pool (linear); entry ids 0..T-1."""
        if ctx.attn_mode == "paged":
            g = pool[ctx.block_tables.long()]
            return g.reshape(g.shape[0], -1, pool.shape[-1])
        return pool[slots]

    def forward(self, x, params: dict, ctx: ForwardCtx):
        B, S, _ = x.shape
        dt, dev = x.dtype, x.device
        H, D, W = self.num_q_heads, self.head_dim, self.sliding_window
        m = self.compress_rate or 1
        positions = ctx.positions
        cached = ctx.cache is not None
        p0 = (ctx.cache_seqlens.long() if cached and ctx.cache_seqlens is not None
              else torch.zeros(B, dtype=torch.long, device=dev))
        valid = positions == p0[:, None] + torch.arange(S, device=dev)[None]
        end = p0 + valid.sum(dim=1)

        q_res = self.q_norm.forward(self.q_a.forward(x, params, ctx), params, ctx)
        q = self.q_b.forward(q_res, params, ctx).reshape(B, S, H, D)
        q = rms_norm(q, torch.ones(D, device=dev), self.rms_norm_eps)
        kv = self.wkv.forward(x, params, ctx).reshape(B, S, D)
        kv = rms_norm(kv, params[self.kv_norm.key]["weight"], self.rms_norm_eps)
        table = self.table("main" if self.layer_type == "sliding" else "compress", dev)
        q = gptj_rope_trailing(q, table, positions)
        kv = gptj_rope_trailing(kv[:, :, None], table, positions)[:, :, 0]

        layer = ctx.cache[self.key] if cached else None
        slots = self._slots(ctx, B, dev)
        use_kernel = (S == 1 and layer is not None and ctx.attn_mode == "paged"
                      and not dsv4_dense_decode())

        # the pools first: late queries of a chunk see entries it emits
        pool_entries = ipool_entries = emit = e = None
        if self.compressor is not None:
            if layer is not None:
                cb = (layer["cb_kv"][slots], layer["cb_gate"][slots])
            else:
                cb = (torch.zeros((B, self.compressor.buf_slots, self.compressor.proj_width),
                                  device=dev),) * 2
            comp, e, emit, nb_kv, nb_g = self.compressor.emit(params, x, ctx, p0, end, *cb)
            if layer is not None:
                self._pool_scatter(layer["pg_pool"], comp, e, emit, ctx, slots)
                layer["cb_kv"][slots] = nb_kv
                layer["cb_gate"][slots] = nb_g
                if not use_kernel:  # the kernels read the pool's pages in place
                    pool_entries = self._pool_gather(layer["pg_pool"], ctx, slots)
            else:
                # bf16 as the cached path stores the pool
                pool_entries = torch.where(emit[..., None], comp, 0.0).to(torch.bfloat16)
        if self.indexer is not None:
            if layer is not None:
                icomp, ie, iemit, inb_kv, inb_g = self.indexer.emit(
                    params, x, ctx, p0, end, layer["icb_kv"][slots], layer["icb_gate"][slots])
                self._pool_scatter(layer["pg_ipool"], icomp, ie, iemit, ctx, slots)
                layer["icb_kv"][slots] = inb_kv
                layer["icb_gate"][slots] = inb_g
                ipool_entries = self._pool_gather(layer["pg_ipool"], ctx, slots)
            else:
                z = torch.zeros((B, self.indexer.buf_slots, self.indexer.proj_width), device=dev)
                icomp, _, iemit, _, _ = self.indexer.emit(params, x, ctx, p0, end, z, z)
                ipool_entries = torch.where(iemit[..., None], icomp, 0.0).to(torch.bfloat16)

        if use_kernel:
            o = self._decode_kernel(q, kv, layer, ctx, slots, positions, end, params, x, q_res,
                                    ipool_entries)
        else:
            o = self._attend_dense(q, kv, layer, slots, positions, valid, p0, end, params, ctx,
                                   x, q_res, pool_entries, ipool_entries, e, emit)
        o = gptj_rope_trailing(o, table, positions, neg=True)
        return self._project_out(o, params, ctx, dt)

    def _attend_dense(self, q, kv, layer, slots, positions, valid, p0, end, params, ctx, x,
                      q_res, pool_entries, ipool_entries, e, emit):
        """Every query over [ring written before the chunk | chunk] in its
        window, the visible pool entries (CSA: the indexer's top k) and the
        sink, one softmax in f32, in blocks of query rows; then the chunk's
        last ring-width valid rows into the ring. -> (B, S, H, D) f32."""
        B, S, H, D = q.shape
        W = self.sliding_window
        m = self.compress_rate or 1
        dev = q.device
        if layer is not None:
            R = layer["kv"].shape[1]
            ring_k = layer["kv"][slots].to(torch.float32)
            ring_pos = layer["pos"][slots]
            # only rows written before this chunk (a stale speculative slot may
            # alias a chunk position)
            ring_ok = (ring_pos >= 0) & (ring_pos < p0[:, None])
            win_k = torch.cat([ring_k, kv.to(torch.float32)], dim=1)
            win_pos = torch.cat([torch.where(ring_ok, ring_pos.long(), -W - 1),
                                 positions.long()], dim=1)
            win_ok = torch.cat([ring_ok, valid], dim=1)
        else:
            win_k, win_pos, win_ok = kv.to(torch.float32), positions.long(), valid
        pf = ent_ids = None
        if pool_entries is not None:
            T = pool_entries.shape[1]
            ent_ids = e if layer is None else torch.arange(T, device=dev)[None].expand(B, T)
            pf = pool_entries.to(torch.float32)
        v_all = win_k if pf is None else torch.cat([win_k, pf], dim=1)
        sinks = params[self.key]["sinks"]
        T_pool = pf.shape[1] if pf is not None else 0
        K_sel = min(self.index_topk, T_pool) if T_pool and self.indexer is not None else 0
        # CSA prefill over a wide pool: each query's selected entries gather
        # compactly ((B, QB, K) scores instead of (B, H, QB, T_pool))
        csa_gather = K_sel and S > 1 and T_pool > 2 * K_sel

        def attend_rows(qf_b, qp_b, x_b, qres_b):
            QB = qf_b.shape[1]
            dlt = qp_b[:, :, None] - win_pos[:, None, :]
            mask_win = win_ok[:, None, :] & (dlt >= 0) & (dlt < W)
            s_win = torch.einsum("bshd,btd->bhst", qf_b, win_k) * self.sm_scale
            parts = [torch.where(mask_win[:, None], s_win, NEG_INF)]
            ent_sel = None
            if pf is not None:
                mask_pool = ent_ids[:, None, :] < ((qp_b + 1) // m)[:, :, None]
                if layer is None:
                    mask_pool = mask_pool & emit[:, None, :]
                if csa_gather:
                    iscores = self._indexer_scores(x_b, qres_b, ipool_entries, qp_b, params, ctx,
                                                   mask_pool)
                    topv, topi = top_k(iscores, K_sel)                   # (B, QB, K)
                    ent_sel = pf[torch.arange(B, device=dev)[:, None, None], topi]
                    s_pool = torch.einsum("bqhd,bqkd->bhqk", qf_b, ent_sel) * self.sm_scale
                    parts.append(torch.where((topv > NEG_INF / 2)[:, None], s_pool, NEG_INF))
                else:
                    s_pool = torch.einsum("bshd,btd->bhst", qf_b, pf) * self.sm_scale
                    if self.indexer is not None:
                        iscores = self._indexer_scores(x_b, qres_b, ipool_entries, qp_b, params,
                                                       ctx, mask_pool)
                        topv, topi = top_k(iscores, min(self.index_topk, iscores.shape[-1]))
                        mask_k = torch.zeros_like(mask_pool).scatter(-1, topi, topv > NEG_INF / 2)
                        mask_pool = mask_pool & mask_k
                    parts.append(torch.where(mask_pool[:, None], s_pool, NEG_INF))
            scores = torch.cat(parts + [sinks[None, :, None, None].expand(B, H, QB, 1)], dim=-1)
            p = torch.softmax(scores, dim=-1)[..., :-1]
            if ent_sel is not None:
                t_win = win_k.shape[1]
                return (torch.einsum("bhst,btd->bshd", p[..., :t_win], win_k)
                        + torch.einsum("bhqk,bqkd->bqhd", p[..., t_win:], ent_sel))
            return torch.einsum("bhst,btd->bshd", p, v_all)

        qf = q.to(torch.float32)
        o = torch.cat([attend_rows(qf[:, i: i + QBLOCK], positions[:, i: i + QBLOCK],
                                   x[:, i: i + QBLOCK], q_res[:, i: i + QBLOCK])
                       for i in range(0, S, QBLOCK)], dim=1)

        if layer is not None:
            # keep the last R valid rows (a chunk may be padded past them)
            keep = (positions >= (end - R)[:, None]) & valid
            b, j = keep.nonzero(as_tuple=True)
            wslot = positions[b, j].long() % R
            layer["kv"][slots[b], wslot] = kv[b, j].to(layer["kv"].dtype)
            layer["pos"][slots[b], wslot] = positions[b, j].to(torch.int32)
        return o

    def _decode_kernel(self, q, kv, layer, ctx, slots, positions, end, params, x, q_res,
                       ipool_entries):
        """S = 1 over a paged cache: the row into its ring slot first (a stale
        speculative slot holds a future position and masks itself), then the
        row 6b kernels over the ring, the HCA pool (entry ids as positions:
        entry e visible iff e < (q_pos + 1) // m) or the CSA selection (the
        indexer's top k gathered into rows, the first min(visible, k)
        visible), and one softmax with the sinks over their stats."""
        R = layer["kv"].shape[1]
        s32 = slots.to(torch.int32)
        qpos = positions.to(torch.int32)
        wslot = positions.long() % R
        layer["kv"][slots[:, None], wslot] = kv.to(layer["kv"].dtype)
        layer["pos"][slots[:, None], wslot] = qpos
        qb = q.to(torch.bfloat16).contiguous()
        parts = [ring_attention_stats(qb, layer["kv"], layer["pos"], s32, qpos,
                                      scale=self.sm_scale, sliding_window=self.sliding_window)]
        mrate = self.compress_rate
        bt = ctx.block_tables
        if self.compressor is not None and self.indexer is None:
            parts.append(pool_attention_stats(
                qb, layer["pg_pool"], bt.to(torch.int32).contiguous(),
                ((positions + 1) // mrate - 1).to(torch.int32),
                torch.clamp(end // mrate, min=0).to(torch.int32), scale=self.sm_scale))
        elif self.compressor is not None:
            pool = layer["pg_pool"]
            epp = pool.shape[1]
            E = ipool_entries.shape[1]
            vis = torch.arange(E, device=q.device)[None] < (positions + 1) // mrate   # (B, E)
            isc = self._indexer_scores(x, q_res, ipool_entries, positions, params, ctx,
                                       vis[:, None, :])[:, 0]
            K = min(self.index_topk, E)
            top_idx = top_k(isc, K)[1]                                               # (B, K)
            vcount = torch.clamp(vis.sum(dim=1), max=K).to(torch.int32)
            page = torch.gather(bt.long(), 1, top_idx // epp)
            sel = pool[page, top_idx % epp].contiguous()                             # (B, K, D)
            parts.append(rows_attention_stats(qb, sel, (vcount - 1)[:, None], vcount,
                                              scale=self.sm_scale))
        return merge_stats(parts, params[self.key]["sinks"])

    def _indexer_scores(self, x, q_res, ipool_entries, positions, params, ctx, mask_pool):
        """The lightning indexer: score[t, e] = sum_h w[t, h] *
        relu(q_idx[t, h] . k_idx[e]) / sqrt(Di * Hi); -inf where mask_pool is
        False."""
        B, S, _ = x.shape
        Hi, Di = self.index_n_heads, self.index_head_dim
        q_idx = self.idx_wq_b.forward(q_res, params, ctx).reshape(B, S, Hi, Di)
        q_idx = gptj_rope_trailing(q_idx, self.table("compress", x.device), positions)
        wts = self.idx_weights.forward(x, params, ctx).to(torch.float32)
        dots = torch.einsum("bshd,btd->bhst", q_idx.to(torch.float32),
                            ipool_entries.to(torch.float32))
        iscores = torch.einsum("bhst,bsh->bst", torch.relu(dots), wts) \
            * (Di ** -0.5) * (Hi ** -0.5)
        return torch.where(mask_pool, iscores, -math.inf)

    def _project_out(self, o, params, ctx, dt):
        B, S, H, D = o.shape
        G = self.o_groups
        og = o.reshape(B, S, G, H // G * D).to(dt)
        mid = torch.cat([self.wo_a[g].forward(og[:, :, g].contiguous(), params, ctx)
                         for g in range(G)], dim=-1)
        return self.wo_b.forward(mid, params, ctx)
