"""Attention over the paged and the linear KV cache, bf16 or quantized
(counterpart of exllamav3_tpu/ops/flash_attention.py::flash_attention, with
block_tables for the paged layout and without for the linear one, with
`latent` for MLA, and with `return_stats` for DeepSeek-V4).

Ten CUDA entries share the key layouts and storages of
csrc/attention_tiles.cuh: csrc/paged_attention.cu and
csrc/linear_attention.cu serve the bf16 cache, csrc/paged_attention_quant.cu
and csrc/linear_attention_quant.cu the quantized one (packed 2..8-bit words
with bf16 group scales, merged-head or per-head storage, unpacked in the
kernel). These four send decode and verify (S * G <= DECODE_ROWS) to
csrc/attention_decode.cuh, which splits each sequence's keys across blocks
(decode_split_keys sizes the splits from host widths) and merges the splits
in the same launch; its plain split arithmetic is paged_attention_split_plain
and linear_attention_split_plain (bf16), paged_attention_quant_split_plain
and linear_attention_quant_split_plain (quantized). All four send every
longer chunk to csrc/attention_prefill.cuh (128 rows a block, q and P as hi +
lo bf16 pairs into Hopper's warpgroup MMAs, the quantized K/V unpacked in the
block into hi + lo pairs too; its plain arithmetic: paged_attention_prefill_plain
and linear_attention_prefill_plain over the bf16 cache,
paged_attention_quant_prefill_plain and linear_attention_quant_prefill_plain
over the quantized one, all over attention_prefill_plain);
attention_route names the body a chunk takes. Each serves decode, prefill
chunks and padded rows: causal by absolute position against total_lens, any
GQA group, optional sliding window, logit softcap and per-head sinks. A row that
sees no valid key gives 0. The linear layout holds one row of T slots per
sequence (slot == position, any T); a step may name the cache row of each of
its sequences. csrc/latent_attention.cu and csrc/latent_attention_quant.cu
serve the absorbed MLA form over DeepSeek's latent cache, paged or linear:
one kv head whose 576-channel row is the latent (512) and the rope key (64),
V the latent itself; bf16, or the latent packed with the rope key in bf16.
Their decode (S = 1) goes through the split-key kernel of
csrc/latent_decode.cuh (splits sized by latent_split_keys, merged in the
launch; its plain split arithmetic: latent_attention_split_plain), verify and
prefill through csrc/latent_prefill.cuh (a pre-pass lays the keys the
launch can see out as tiles in a scratch, dequantized over the quantized
latent; then 64 rows a block on warpgroup MMAs; its plain arithmetic:
latent_attention_prefill_plain and latent_attention_quant_prefill_plain).
csrc/ring_attention.cu serves decode (S = 1) over a sliding-window layer's
ring (`ring_attention`): each sequence's ring row holds W slots of bf16 K/V
beside the position each slot holds, and the positions decide visibility.
For a group of up to DECODE_ROWS heads it too launches the split-key decode
kernel, over the ring's slots (its plain split arithmetic:
ring_attention_split_plain); wider groups take the tile loop.
On a CPU tensor a wrapper runs its plain version, built on ops/attention.py.
`paged_attention_any`, `linear_attention_any` and `latent_attention_any` pick
the storage by the layer state's keys (modules/attn.py picks the layout by
the cache's). The JAX package dequantizes a whole merged pool for tall
chunks (a TPU tile-occupancy matter); the port's kernels take any S.
The `return_stats` form (the unnormalised output with each row's max m and
sum l, for a caller that merges several key sources in one softmax) serves
DeepSeek-V4's decode over one 512-wide row that is K and V alike:
csrc/attention_stats.cu's three entries, `ring_attention_stats` (the
sliding ring), `pool_attention_stats` (a compressed pool of `epp` entries a
page through the token block table) and `rows_attention_stats` (selected
entries gathered into rows), each with its plain version, and `merge_stats`,
the JAX package's epilogue that joins them with the sink logits. The three
launch the latent decode kernel (csrc/latent_decode.cuh) at 512 channels with
its stats epilogue, its splits sized by latent_split_keys over the layout's
width; their plain versions with `split_keys` are its split arithmetic.
"""
from __future__ import annotations

import functools

import torch

from ..constants import PAGE_SIZE
from ..util.device import H100_SMS, arrival_counters, device_sms, scratch
from .attention import attend_dense, attend_paged
from .build import check_aligned, check_launch, header_constants, library
from .kv_quant import dequantize_rotated, quant_cache_fetch, rotate_groups, state_heads

LATENT, ROPE = 512, 64  # the latent kernels' row: DeepSeek's kv_lora_rank and rope key


def has_valid_key(q_positions, total_lens, sliding_window: int = 0) -> torch.Tensor:
    """(B, S) bool: the row sees at least one key."""
    hi = torch.minimum(q_positions, total_lens[:, None] - 1)
    lo = (torch.clamp(q_positions - sliding_window + 1, min=0) if sliding_window
          else torch.zeros_like(q_positions))
    return hi >= lo


def paged_attention_plain(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                          scale: float = 1.0, sliding_window: int = 0,
                          logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32: attend_paged, with rows that see no key set to 0."""
    o = attend_paged(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                     scale=scale, sliding_window=sliding_window,
                     logit_softcap=logit_softcap, sinks=sinks)
    valid = has_valid_key(q_positions, total_lens, sliding_window)
    return o * valid[:, :, None, None].to(o.dtype)


def paged_attention_kernel(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                           scale: float = 1.0, sliding_window: int = 0,
                           logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """Launch csrc/paged_attention.cu. q (B, S, Hq, D) f32; k/v pages
    (P, 256, Hk, D) bf16; block_tables (B, MP), q_positions (B, S) and
    total_lens (B,) int32; sinks (Hq,) f32 or None; D in {64, 128}, any GQA
    group. With S * G <= DECODE_ROWS the split-key decode kernel runs
    (splits sized by decode_split_keys for this card), a longer chunk the
    prefill body of csrc/attention_prefill.cuh (attention_route), whose
    launches paged_attention_prefill also counts."""
    B, S, Hq, D = q.shape
    P, PS, Hk, Dk = k_pages.shape
    ints = (block_tables, q_positions, total_lens)
    tensors = (q, k_pages, v_pages) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or k_pages.dtype != torch.bfloat16
            or v_pages.dtype != torch.bfloat16 or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("paged_attention_kernel: expected f32 q, bf16 k/v, int32 tables "
                        "and positions, f32 sinks")
    if (PS != PAGE_SIZE or Dk != D or v_pages.shape != k_pages.shape or D not in (64, 128)
            or Hq % Hk or block_tables.shape[0] != B
            or q_positions.shape != (B, S) or total_lens.shape != (B,)
            or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"paged_attention_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, tables {tuple(block_tables.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_kernel: tensors must be contiguous")
    check_aligned("paged_attention_kernel", q, k_pages, v_pages)
    MP = block_tables.shape[1]
    _, ws, counters, split_keys = _decode_launch(q, Hk, MP * PAGE_SIZE, device_sms(q.device),
                                                 rotate=False)
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        q_positions.data_ptr(), total_lens.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(), _ptr(ws),
        _ptr(counters), B, S, Hq, Hk, D, MP, P, float(scale), int(sliding_window),
        float(logit_softcap), split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_paged_attention", err)
    paged_attention_kernel.launches += 1
    if ws is None:
        paged_attention_prefill.launches += 1
    return out


paged_attention_kernel.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                    scale: float = 1.0, sliding_window: int = 0,
                    logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32. CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    fn = paged_attention_plain if q.device.type == "cpu" else paged_attention_kernel
    return fn(q, k_pages, v_pages, block_tables, q_positions, total_lens, scale=scale,
              sliding_window=sliding_window, logit_softcap=logit_softcap, sinks=sinks)


# -- quantized cache ------------------------------------------------------------

# The split-key decode kernel (csrc/attention_decode.cuh) serves a chunk whose
# (sequence, kv head) has at most DECODE_ROWS query rows (S * G); its keys are
# cut into splits of a power of two from one DECODE_TILE-key tile, at most
# DECODE_MAX_SPLITS of them, so that the grid (splits, Hk, B) holds about
# DECODE_BLOCKS_PER_SM blocks for each of the card's SMs: enough that the
# splits of a long sequence spread while short ones end early. The three
# limits are the header's own.
DECODE_ROWS, DECODE_TILE, DECODE_MAX_SPLITS, RING_TILES = header_constants(
    "attention_decode.cuh", "DECODE_ROWS", "DEC_TK", "DEC_MAX_SPLITS", "DEC_RING_TILES")
# slots of a ring row the decode kernel takes: DECODE_MAX_SPLITS splits of at
# most RING_TILES tiles of the bf16 storage's widest, 64 slots
RING_MAX_SLOTS = DECODE_MAX_SPLITS * RING_TILES * DECODE_TILE
DECODE_BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=None)  # a served step asks for a few widths hundreds of times
def decode_split_keys(width: int, B: int, Hk: int, sms: int = H100_SMS) -> int:
    """Keys a split of the decode kernel covers, from widths the host knows:
    the layout's keys a sequence (the block table's width times 256, or the
    linear cache's T), the batch, the kv heads and the card's SM count.
    Below a page it divides the page; above, it holds whole pages."""
    want = min(DECODE_MAX_SPLITS, max(1, -(-DECODE_BLOCKS_PER_SM * sms // (B * Hk))))
    split = DECODE_TILE
    while -(-width // split) > want:
        split *= 2
    return split


def _decode_launch(q, Hk: int, width: int, sms: int, rotate: bool) -> tuple:
    """(q as the launch takes it, workspace, counters, split_keys) for the
    four entries over the paged and the linear cache: the decode kernel
    takes q as it is, a workspace of (acc, m, l) for each split of
    decode_split_keys's size and the arrival counters; the prefill body takes
    none of them, and q rotated per 32-channel group when `rotate` (the
    quantized storage: the prefill body scores in the stored, rotated
    basis)."""
    B, S, Hq, D = q.shape
    if attention_route(S, Hq, Hk) != "decode":
        return rotate_groups(q) if rotate else q, None, None, 0
    split_keys = decode_split_keys(width, B, Hk, sms)
    splits = -(-width // split_keys)
    ws = torch.empty(B * Hk * splits * S * (Hq // Hk) * (D + 2), dtype=torch.float32,
                     device=q.device)
    return q, ws, arrival_counters(q.device, B * Hk), split_keys


# The prefill body (csrc/attention_prefill.cuh) serves every longer chunk of
# the bf16 and the quantized entries over the paged and the linear cache: a
# block holds PREFILL_ROWS (token, head-in-group) rows and walks
# PREFILL_TILE-key tiles. The two widths are the header's own.
PREFILL_ROWS, PREFILL_TILE = header_constants("attention_prefill.cuh", "PF_ROWS", "PF_TK")


def attention_route(S: int, Hq: int, Hk: int) -> str:
    """The body an entry over the paged or the linear cache, bf16 or
    quantized, launches for a chunk of S tokens: "decode"
    (csrc/attention_decode.cuh) while a (sequence, kv head) has at most
    DECODE_ROWS query rows (S * G), else "prefill"
    (csrc/attention_prefill.cuh). The C entries choose by the same rule."""
    return "decode" if S * (Hq // Hk) <= DECODE_ROWS else "prefill"


class LaunchCount:
    """The launches of one body of an entry whose wrapper counts all of them
    (the prefill body's of paged_attention_kernel, linear_attention_kernel,
    paged_attention_quant_kernel and linear_attention_quant_kernel, and the
    latent prefill body's of latent_attention_kernel and
    latent_attention_quant_kernel)."""

    def __init__(self):
        self.launches = 0


paged_attention_prefill = LaunchCount()
linear_attention_prefill = LaunchCount()
paged_attention_quant_prefill = LaunchCount()
linear_attention_quant_prefill = LaunchCount()


def _hi_lo(x) -> tuple:
    """(hi, lo) f32 of x as the kernels' bf16 pairs: hi = bf16(x), lo =
    bf16(x - hi)."""
    xf = x.float()
    hi = xf.to(torch.bfloat16).float()
    return hi, (xf - hi).to(torch.bfloat16).float()


def attention_prefill_plain(q, k, v, visible, scale: float = 1.0, logit_softcap: float = 0.0,
                            sinks=None, rows: int = PREFILL_ROWS,
                            tile: int = PREFILL_TILE) -> torch.Tensor:
    """(B, S, Hq, D) f32: the prefill body's arithmetic in plain torch. q
    (B, S, Hq, D) f32 (or bf16: its lo term is 0); k (B, T, Hk, D), v
    (B, T, Hk, Dv), each sequence's keys in order: bf16 (the bf16 cache), or
    f32 (the quantized cache's values, which enter the products as hi + lo
    bf16 pairs, as the kernel unpacks them); visible (B, S, T) bool. As the
    kernel, the walk goes by q blocks of `rows` (token, head-in-group) rows
    (min(G, rows) heads, rows // that tokens; here every head of a token at
    once, which computes the same rows) and, in each, by `tile`-key tiles
    from the first key a row of the block sees to the last (the latent body,
    csrc/latent_prefill.cuh: 64 rows, 32-key tiles). q and P enter the
    products as hi + lo bf16 pairs; scores are scale * (q_hi.k_hi + q_lo.k_hi
    + q_hi.k_lo), the last term for f32 K only (the lo.lo term left out),
    then the softcap, then the mask; the online softmax keeps its running
    max m, sum l (of P in f32) and output (P_hi.V_hi + P_lo.V_hi +
    P_hi.V_lo) in f32, m starting at the head's sink (l at 1) where there
    are sinks; the output is divided by
    max(l, 1e-30), so a row that sees no key gives 0. All q blocks walk the
    tiles together, from the first key any row sees to the last: a tile that
    no row of a block sees leaves that block's state exactly as it was, so
    this is each block's own walk."""
    B, S, Hq, D = q.shape
    T, Hk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hk
    QT = rows // min(G, rows)  # tokens a block
    nb = -(-S // QT)
    pad = nb * QT - S  # tokens of the last block past S: they see no key

    def blocks(t):  # (B, S, Hq, X) -> (B, Hk, nb, QT * G, X): row (s, g) is q head hk * G + g
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nb, QT, Hk, G, -1).permute(0, 3, 1, 2, 4, 5).reshape(
            B, Hk, nb, QT * G, t.shape[-1])

    q_hi, q_lo = (blocks(t) for t in _hi_lo(q))

    def operand(t) -> tuple:  # (B, Hk, 1, T, D) hi and lo; lo None for bf16 values
        hi, lo = (t.float(), None) if t.dtype == torch.bfloat16 else _hi_lo(t)
        return tuple(None if x is None else x.permute(0, 2, 1, 3)[:, :, None] for x in (hi, lo))

    kf, k_lo = operand(k)
    vf, v_lo = operand(v)
    vis = torch.nn.functional.pad(visible, (0, 0, 0, pad))  # (B, nb * QT, T)
    # (B, 1, nb, QT * G, T): the mask of row (s, g) is token s's
    mask = vis.reshape(B, nb, QT, 1, T).expand(B, nb, QT, G, T).reshape(B, 1, nb, QT * G, T)
    shape = (B, Hk, nb, QT * G)
    if sinks is None:
        m = torch.full(shape, -torch.inf, device=q.device)
        l = torch.zeros(shape, device=q.device)
    else:
        m = sinks.float().to(q.device).reshape(1, Hk, 1, 1, G).expand(B, Hk, nb, QT, G)
        m = m.reshape(shape).clone()
        l = torch.ones(shape, device=q.device)
    o = torch.zeros((*shape, Dv), device=q.device)
    seen = vis.any(dim=1).any(dim=0).nonzero()
    lo, hi = (int(seen.min()), int(seen.max())) if seen.numel() else (0, -1)
    for key0 in range(lo // tile * tile, hi + 1, tile):
        kt = kf[..., key0:key0 + tile, :]
        vt = vf[..., key0:key0 + tile, :]
        sc = q_hi @ kt.transpose(-1, -2) + q_lo @ kt.transpose(-1, -2)
        if k_lo is not None:
            sc = sc + q_hi @ k_lo[..., key0:key0 + tile, :].transpose(-1, -2)
        sc = sc * scale
        if logit_softcap > 0.0:
            sc = torch.tanh(sc / logit_softcap) * logit_softcap
        sc = sc.masked_fill(~mask[..., key0:key0 + tile], -torch.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - m_new))
        base = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
        p = torch.exp(sc - base[..., None])
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        l = l * alpha + p.sum(dim=-1)
        pv = p_hi @ vt + p_lo @ vt
        if v_lo is not None:
            pv = pv + p_hi @ v_lo[..., key0:key0 + tile, :]
        o = o * alpha[..., None] + pv
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    # (B, Hk, nb, QT, G, Dv) -> (B, S, Hq, Dv)
    o = o.reshape(B, Hk, nb, QT, G, Dv).permute(0, 2, 3, 1, 4, 5).reshape(B, nb * QT, Hq, Dv)
    return o[:, :S].contiguous()


def paged_attention_prefill_plain(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                                  scale: float = 1.0, sliding_window: int = 0,
                                  logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the paged bf16 cache by the prefill body's
    arithmetic (attention_prefill_plain over each sequence's pages in table
    order); pages out of range hold no visible key."""
    B = q.shape[0]
    ok = (block_tables >= 0) & (block_tables < k_pages.shape[0])
    bt = torch.where(ok, block_tables, torch.zeros_like(block_tables)).long()
    T = bt.shape[1] * PAGE_SIZE
    k, v = (t[bt].reshape(B, T, *t.shape[2:]) for t in (k_pages, v_pages))
    vis = (_causal_visible(q_positions, total_lens, T, q.device, sliding_window)
           & ok.repeat_interleave(PAGE_SIZE, dim=1)[:, None, :])
    return attention_prefill_plain(q, k, v, vis, scale, logit_softcap, sinks)


def linear_attention_prefill_plain(q, k, v, q_positions, total_lens, rows=None,
                                   scale: float = 1.0, sliding_window: int = 0,
                                   logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the linear bf16 cache k, v (N, T, Hk, D) (row
    b, or rows[b]) by the prefill body's arithmetic."""
    pick = slice(0, q.shape[0]) if rows is None else rows.long()
    vis = _causal_visible(q_positions, total_lens, k.shape[1], q.device, sliding_window)
    return attention_prefill_plain(q, k[pick], v[pick], vis, scale, logit_softcap, sinks)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rotated_kv(layer_state: dict, k_bits: int, v_bits: int, compand_a: float, Hk: int) -> tuple:
    """(k, v) (..., Hk, D) f32 in the stored, rotated basis: the values the
    kernels unpack, from either storage."""
    out = []
    for name, bits in (("k", k_bits), ("v", v_bits)):
        words, scales = layer_state[name + "_q"], layer_state[name + "_s"]
        if words.dim() == 3:  # merged: the same bytes as per head
            words = words.reshape(*words.shape[:2], Hk, -1)
            scales = scales.reshape(*scales.shape[:2], Hk, -1)
        out.append(dequantize_rotated(words, scales, bits, compand_a))
    return tuple(out)


def attention_split_plain(q, k, v, visible, split_keys: int, scale: float = 1.0,
                          logit_softcap: float = 0.0, sinks=None,
                          rotate: bool = True) -> torch.Tensor:
    """(B, S, Hq, D) f32: the decode kernel's arithmetic in plain torch. q
    (B, S, Hq, D) f32 unrotated; k, v (B, T, Hk, D) f32, in the rotated
    basis when `rotate` (the quantized storage; bf16 K/V as they are
    otherwise); visible (B, S, T). With `rotate` q is rotated; the keys are
    cut into splits of split_keys, each split gives (acc, m, l) as
    attend_stats_plain does, merge_stats joins them with the sinks, and with
    `rotate` the output is rotated back."""
    qr = rotate_groups(q.float()) if rotate else q.float()
    parts = [attend_stats_plain(qr, k[:, k0:k0 + split_keys], visible[..., k0:k0 + split_keys],
                                scale, v=v[:, k0:k0 + split_keys], logit_softcap=logit_softcap)
             for k0 in range(0, k.shape[1], split_keys)]
    o = merge_stats(parts, sinks)
    return rotate_groups(o) if rotate else o


def paged_attention_split_plain(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                                scale: float = 1.0, sliding_window: int = 0,
                                logit_softcap: float = 0.0, sinks=None,
                                split_keys: int | None = None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the paged bf16 cache by the decode kernel's
    split arithmetic (attention_split_plain without rotation, K/V as f32),
    cut by decode_split_keys at H100_SMS unless split_keys is given; pages
    out of range hold no visible key."""
    B, Hk = q.shape[0], k_pages.shape[2]
    ok = (block_tables >= 0) & (block_tables < k_pages.shape[0])
    bt = torch.where(ok, block_tables, torch.zeros_like(block_tables)).long()
    T = bt.shape[1] * PAGE_SIZE
    k, v = (t[bt].reshape(B, T, *t.shape[2:]).float() for t in (k_pages, v_pages))
    vis = (_causal_visible(q_positions, total_lens, T, q.device, sliding_window)
           & ok.repeat_interleave(PAGE_SIZE, dim=1)[:, None, :])
    return attention_split_plain(q, k, v, vis, split_keys or decode_split_keys(T, B, Hk), scale,
                                 logit_softcap, sinks, rotate=False)


def _paged_quant_keys(q, layer_state: dict, block_tables, q_positions, total_lens, k_bits: int,
                      v_bits: int, compand_a: float, sliding_window: int) -> tuple:
    """(k, v (B, T, Hk, D) f32 in the rotated basis, visible (B, S, T)) of
    each sequence's pages of the quantized cache in table order; pages out
    of range hold no visible key."""
    B, S, Hq, D = q.shape
    Hk = state_heads(layer_state, D)
    P, MP = layer_state["k_q"].shape[0], block_tables.shape[1]
    ok = (block_tables >= 0) & (block_tables < P)
    bt = torch.where(ok, block_tables, torch.zeros_like(block_tables)).long()
    k, v = _rotated_kv({n: t[bt] for n, t in layer_state.items()}, k_bits, v_bits, compand_a, Hk)
    T = MP * PAGE_SIZE
    vis = (_causal_visible(q_positions, total_lens, T, q.device, sliding_window)
           & ok.repeat_interleave(PAGE_SIZE, dim=1)[:, None, :])
    return k.reshape(B, T, Hk, D), v.reshape(B, T, Hk, D), vis


def _linear_quant_keys(q, layer_state: dict, q_positions, total_lens, k_bits: int, v_bits: int,
                       compand_a: float, rows, sliding_window: int) -> tuple:
    """(k, v (B, T, Hk, D) f32 in the rotated basis, visible (B, S, T)) of
    each sequence's row of the linear quantized cache (row b, or rows[b])."""
    pick = slice(0, q.shape[0]) if rows is None else rows.long()
    k, v = _rotated_kv({n: t[pick] for n, t in layer_state.items()}, k_bits, v_bits, compand_a,
                       state_heads(layer_state, q.shape[-1]))
    return k, v, _causal_visible(q_positions, total_lens, k.shape[1], q.device, sliding_window)


def paged_attention_quant_split_plain(q, layer_state: dict, block_tables, q_positions,
                                      total_lens, k_bits: int, v_bits: int,
                                      compand_a: float = 0.0, scale: float = 1.0,
                                      sliding_window: int = 0, logit_softcap: float = 0.0,
                                      sinks=None, split_keys: int | None = None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the paged quantized cache by the decode
    kernel's split arithmetic (attention_split_plain), cut by
    decode_split_keys at H100_SMS unless split_keys is given; pages out of
    range hold no visible key."""
    k, v, vis = _paged_quant_keys(q, layer_state, block_tables, q_positions, total_lens, k_bits,
                                  v_bits, compand_a, sliding_window)
    B, T, Hk = k.shape[:3]
    return attention_split_plain(q, k, v, vis, split_keys or decode_split_keys(T, B, Hk), scale,
                                 logit_softcap, sinks)


def linear_attention_quant_split_plain(q, layer_state: dict, q_positions, total_lens,
                                       k_bits: int, v_bits: int, compand_a: float = 0.0,
                                       rows=None, scale: float = 1.0, sliding_window: int = 0,
                                       logit_softcap: float = 0.0, sinks=None,
                                       split_keys: int | None = None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the linear quantized cache (row b, or rows[b])
    by the decode kernel's split arithmetic, as
    paged_attention_quant_split_plain."""
    k, v, vis = _linear_quant_keys(q, layer_state, q_positions, total_lens, k_bits, v_bits,
                                   compand_a, rows, sliding_window)
    B, T, Hk = k.shape[:3]
    return attention_split_plain(q, k, v, vis, split_keys or decode_split_keys(T, B, Hk), scale,
                                 logit_softcap, sinks)


def paged_attention_quant_prefill_plain(q, layer_state: dict, block_tables, q_positions,
                                        total_lens, k_bits: int, v_bits: int,
                                        compand_a: float = 0.0, scale: float = 1.0,
                                        sliding_window: int = 0, logit_softcap: float = 0.0,
                                        sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the paged quantized cache by the prefill body's
    arithmetic: q rotated per 32-channel group (as the wrapper hands it to
    the kernel), attention_prefill_plain over the rotated values the kernel
    unpacks (hi + lo bf16 pairs), the output rotated back; pages out of
    range hold no visible key."""
    k, v, vis = _paged_quant_keys(q, layer_state, block_tables, q_positions, total_lens, k_bits,
                                  v_bits, compand_a, sliding_window)
    return rotate_groups(attention_prefill_plain(rotate_groups(q.float()), k, v, vis, scale,
                                                 logit_softcap, sinks))


def linear_attention_quant_prefill_plain(q, layer_state: dict, q_positions, total_lens,
                                         k_bits: int, v_bits: int, compand_a: float = 0.0,
                                         rows=None, scale: float = 1.0, sliding_window: int = 0,
                                         logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the linear quantized cache (row b, or rows[b])
    by the prefill body's arithmetic, as paged_attention_quant_prefill_plain."""
    k, v, vis = _linear_quant_keys(q, layer_state, q_positions, total_lens, k_bits, v_bits,
                                   compand_a, rows, sliding_window)
    return rotate_groups(attention_prefill_plain(rotate_groups(q.float()), k, v, vis, scale,
                                                 logit_softcap, sinks))


def paged_attention_quant_plain(q, layer_state: dict, block_tables, q_positions, total_lens,
                                k_bits: int, v_bits: int, compand_a: float = 0.0,
                                scale: float = 1.0, sliding_window: int = 0,
                                logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32: the gathered pages dequantized to f32 (as the
    kernel holds them), then the plain paged attention."""
    o = attend_paged(q, None, None, block_tables, q_positions, total_lens, scale=scale,
                     sliding_window=sliding_window, logit_softcap=logit_softcap, sinks=sinks,
                     quant_state=layer_state, k_bits=k_bits, v_bits=v_bits,
                     compand_a=compand_a, quant_dtype=torch.float32)
    valid = has_valid_key(q_positions, total_lens, sliding_window)
    return o * valid[:, :, None, None].to(o.dtype)


def paged_attention_quant_kernel(q, layer_state: dict, block_tables, q_positions, total_lens,
                                 k_bits: int, v_bits: int, compand_a: float = 0.0,
                                 scale: float = 1.0, sliding_window: int = 0,
                                 logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """Launch csrc/paged_attention_quant.cu. q (B, S, Hq, D) f32;
    layer_state {k_q, v_q int32 words, k_s, v_s bf16 scales}, merged
    (P, 256, Hk*w) or per-head (P, 256, Hk, w); block_tables (B, MP),
    q_positions (B, S) and total_lens (B,) int32; sinks (Hq,) f32 or None;
    k_bits, v_bits in 2..8; D in {64, 128}, any GQA group. K and V stay in
    their stored, rotated basis. With S * G <= DECODE_ROWS the split-key
    decode kernel runs (splits sized by decode_split_keys for this card) and
    rotates q and the output itself; a longer chunk takes the prefill body of
    csrc/attention_prefill.cuh (counted by paged_attention_quant_prefill
    too), q rotated per 32-channel group before the launch and the output
    rotated back after it."""
    B, S, Hq, D = q.shape
    kq, ks, vq, vs = (layer_state[n] for n in ("k_q", "k_s", "v_q", "v_s"))
    ints = (block_tables, q_positions, total_lens)
    tensors = (q, kq, ks, vq, vs) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_quant_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or kq.dtype != torch.int32 or vq.dtype != torch.int32
            or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16
            or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("paged_attention_quant_kernel: expected f32 q, int32 words, bf16 "
                        "scales, int32 tables and positions, f32 sinks")
    if D not in (64, 128) or not (2 <= k_bits <= 8 and 2 <= v_bits <= 8):
        raise ValueError(f"paged_attention_quant_kernel: unsupported D {D} or bits "
                         f"({k_bits}, {v_bits})")
    Hk = state_heads(layer_state, D)
    P, PS = kq.shape[:2]
    g = D // 32
    want = {"k_q": Hk * D * k_bits // 32, "k_s": Hk * g, "v_q": Hk * D * v_bits // 32,
            "v_s": Hk * g}
    if (PS != PAGE_SIZE or Hk < 1 or Hq % Hk
            or any(layer_state[n].shape[:2] != (P, PS) or layer_state[n][0, 0].numel() != w
                   for n, w in want.items())
            or block_tables.shape[0] != B or q_positions.shape != (B, S)
            or total_lens.shape != (B,) or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"paged_attention_quant_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"k_q {tuple(kq.shape)}, v_q {tuple(vq.shape)}, "
                         f"tables {tuple(block_tables.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_quant_kernel: tensors must be contiguous")
    MP = block_tables.shape[1]
    qk, ws, counters, split_keys = _decode_launch(q, Hk, MP * PAGE_SIZE, device_sms(q.device),
                                                  rotate=True)
    check_aligned("paged_attention_quant_kernel", qk, kq, vq)
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_paged_attention_quant(
        qk.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), total_lens.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(), _ptr(ws),
        _ptr(counters), B, S, Hq, Hk, D, MP, P, int(k_bits), int(v_bits), float(compand_a),
        float(1.0 - compand_a), float(scale), int(sliding_window), float(logit_softcap),
        split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_paged_attention_quant", err)
    paged_attention_quant_kernel.launches += 1
    if ws is not None:
        return out
    paged_attention_quant_prefill.launches += 1
    return rotate_groups(out)


paged_attention_quant_kernel.launches = 0


def paged_attention_any(q, layer_state: dict, block_tables, q_positions, total_lens,
                        k_bits: int = 0, v_bits: int = 0, compand_a: float = 0.0, **kw):
    """(B, S, Hq, D) f32. Dispatch by the layer state's keys: {"k", "v"} is
    the bf16 cache, {"k_q", "k_s", "v_q", "v_s"} the quantized one; CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    if "k_q" in layer_state:
        fn = (paged_attention_quant_plain if q.device.type == "cpu"
              else paged_attention_quant_kernel)
        return fn(q, layer_state, block_tables, q_positions, total_lens, k_bits, v_bits,
                  compand_a, **kw)
    return paged_attention(q, layer_state["k"], layer_state["v"], block_tables, q_positions,
                           total_lens, **kw)


# -- linear cache -----------------------------------------------------------------

def linear_attention_plain(q, k, v, q_positions, total_lens, rows=None, scale: float = 1.0,
                           sliding_window: int = 0, logit_softcap: float = 0.0,
                           sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over a linear cache k, v (N, T, Hk, D): dense
    attention over the keys at positions 0..T-1 of each sequence's row (row b,
    or rows[b]), keys at or past total_lens masked, as the JAX package's dense
    linear branch computes it (modules/attn.py, attend_dense over
    k_positions = arange(T)); rows that see no key set to 0."""
    B, T = q.shape[0], k.shape[1]
    k, v = (k[:B], v[:B]) if rows is None else (k[rows.long()], v[rows.long()])
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)[None].expand(B, T)
    o = attend_dense(q, k, v, q_positions, k_pos, k_valid=k_pos < total_lens[:, None],
                     scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
                     sinks=sinks)
    valid = has_valid_key(q_positions, torch.clamp(total_lens, max=T), sliding_window)
    return o * valid[:, :, None, None].to(o.dtype)


def _linear_rows(rows, B: int, N: int, device) -> int | None:
    """The kernels' row pointer: None (rows 0..B-1, which must exist) or a
    contiguous (B,) int32 CUDA tensor's address."""
    if rows is None:
        if B > N:
            raise ValueError(f"{B} sequences over a linear cache of {N} rows need `rows`")
        return None
    if (rows.shape != (B,) or rows.dtype != torch.int32 or rows.device != device
            or not rows.is_contiguous()):
        raise ValueError("rows must be a contiguous (B,) int32 tensor on the device of q")
    return rows.data_ptr()


def linear_attention_split_plain(q, k, v, q_positions, total_lens, rows=None,
                                 scale: float = 1.0, sliding_window: int = 0,
                                 logit_softcap: float = 0.0, sinks=None,
                                 split_keys: int | None = None) -> torch.Tensor:
    """(B, S, Hq, D) f32 over the linear bf16 cache k, v (N, T, Hk, D) (row
    b, or rows[b]) by the decode kernel's split arithmetic, as
    paged_attention_split_plain."""
    B, T, Hk = q.shape[0], k.shape[1], k.shape[2]
    pick = slice(0, B) if rows is None else rows.long()
    vis = _causal_visible(q_positions, total_lens, T, q.device, sliding_window)
    return attention_split_plain(q, k[pick].float(), v[pick].float(), vis,
                                 split_keys or decode_split_keys(T, B, Hk), scale, logit_softcap,
                                 sinks, rotate=False)


def linear_attention_kernel(q, k, v, q_positions, total_lens, rows=None, scale: float = 1.0,
                            sliding_window: int = 0, logit_softcap: float = 0.0,
                            sinks=None) -> torch.Tensor:
    """Launch csrc/linear_attention.cu. q (B, S, Hq, D) f32; k, v (N, T, Hk, D)
    bf16, any T; rows (B,) int32 or None (rows 0..B-1); q_positions (B, S)
    and total_lens (B,) int32; sinks (Hq,) f32 or None; D in {64, 128}, any
    GQA group. Decode and verify (S * G <= DECODE_ROWS) run the split-key
    kernel, a longer chunk the prefill body (counted by
    linear_attention_prefill too), as paged_attention_kernel."""
    B, S, Hq, D = q.shape
    N, T, Hk, Dk = k.shape
    ints = (q_positions, total_lens)
    tensors = (q, k, v) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("linear_attention_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16
            or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("linear_attention_kernel: expected f32 q, bf16 k/v, int32 positions "
                        "and lengths, f32 sinks")
    if (Dk != D or v.shape != k.shape or D not in (64, 128) or T < 1 or Hq % Hk
            or q_positions.shape != (B, S) or total_lens.shape != (B,)
            or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"linear_attention_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_attention_kernel: tensors must be contiguous")
    check_aligned("linear_attention_kernel", q, k, v)
    rows_ptr = _linear_rows(rows, B, N, q.device)
    _, ws, counters, split_keys = _decode_launch(q, Hk, T, device_sms(q.device), rotate=False)
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_linear_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rows_ptr, q_positions.data_ptr(),
        total_lens.data_ptr(), sinks.data_ptr() if sinks is not None else None, out.data_ptr(),
        _ptr(ws), _ptr(counters), B, S, Hq, Hk, D, N, T, float(scale), int(sliding_window),
        float(logit_softcap), split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_linear_attention", err)
    linear_attention_kernel.launches += 1
    if ws is None:
        linear_attention_prefill.launches += 1
    return out


linear_attention_kernel.launches = 0


def linear_attention_quant_plain(q, layer_state: dict, q_positions, total_lens, k_bits: int,
                                 v_bits: int, compand_a: float = 0.0, rows=None, **kw):
    """(B, S, Hq, D) f32: the named rows of the quantized linear cache
    dequantized to f32 (as the kernel holds them), then the plain linear
    attention."""
    pick = slice(0, q.shape[0]) if rows is None else rows.long()
    layer_state = {n: t[pick] for n, t in layer_state.items()}
    k, v = quant_cache_fetch(layer_state, k_bits, v_bits, torch.float32, compand_a,
                             hk=state_heads(layer_state, q.shape[-1]))
    return linear_attention_plain(q, k, v, q_positions, total_lens, **kw)


def linear_attention_quant_kernel(q, layer_state: dict, q_positions, total_lens, k_bits: int,
                                  v_bits: int, compand_a: float = 0.0, rows=None,
                                  scale: float = 1.0, sliding_window: int = 0,
                                  logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """Launch csrc/linear_attention_quant.cu. q (B, S, Hq, D) f32; layer_state
    {k_q, v_q int32 words, k_s, v_s bf16 scales}, merged (N, T, Hk*w) or
    per-head (N, T, Hk, w), any T; rows (B,) int32 or None; q_positions (B, S)
    and total_lens (B,) int32; sinks (Hq,) f32 or None; k_bits, v_bits in
    2..8; D in {64, 128}, any GQA group. Decode and verify (S * G <=
    DECODE_ROWS) run the split-key kernel, which rotates q and the output
    itself; a longer chunk takes the prefill body (counted by
    linear_attention_quant_prefill too), q and the output rotated around it,
    as paged_attention_quant_kernel."""
    B, S, Hq, D = q.shape
    kq, ks, vq, vs = (layer_state[n] for n in ("k_q", "k_s", "v_q", "v_s"))
    ints = (q_positions, total_lens)
    tensors = (q, kq, ks, vq, vs) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("linear_attention_quant_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or kq.dtype != torch.int32 or vq.dtype != torch.int32
            or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16
            or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("linear_attention_quant_kernel: expected f32 q, int32 words, bf16 "
                        "scales, int32 positions and lengths, f32 sinks")
    if D not in (64, 128) or not (2 <= k_bits <= 8 and 2 <= v_bits <= 8):
        raise ValueError(f"linear_attention_quant_kernel: unsupported D {D} or bits "
                         f"({k_bits}, {v_bits})")
    Hk = state_heads(layer_state, D)
    N, T = kq.shape[:2]
    g = D // 32
    want = {"k_q": Hk * D * k_bits // 32, "k_s": Hk * g, "v_q": Hk * D * v_bits // 32,
            "v_s": Hk * g}
    if (T < 1 or Hk < 1 or Hq % Hk
            or any(layer_state[n].shape[:2] != (N, T) or layer_state[n][0, 0].numel() != w
                   for n, w in want.items())
            or q_positions.shape != (B, S) or total_lens.shape != (B,)
            or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"linear_attention_quant_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"k_q {tuple(kq.shape)}, v_q {tuple(vq.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_attention_quant_kernel: tensors must be contiguous")
    rows_ptr = _linear_rows(rows, B, N, q.device)
    qk, ws, counters, split_keys = _decode_launch(q, Hk, T, device_sms(q.device), rotate=True)
    check_aligned("linear_attention_quant_kernel", qk, kq, vq)
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_linear_attention_quant(
        qk.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), rows_ptr,
        q_positions.data_ptr(), total_lens.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(), _ptr(ws),
        _ptr(counters), B, S, Hq, Hk, D, N, T, int(k_bits), int(v_bits), float(compand_a),
        float(1.0 - compand_a), float(scale), int(sliding_window), float(logit_softcap),
        split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_linear_attention_quant", err)
    linear_attention_quant_kernel.launches += 1
    if ws is not None:
        return out
    linear_attention_quant_prefill.launches += 1
    return rotate_groups(out)


linear_attention_quant_kernel.launches = 0


def linear_attention_any(q, layer_state: dict, q_positions, total_lens, k_bits: int = 0,
                         v_bits: int = 0, compand_a: float = 0.0, rows=None, **kw):
    """(B, S, Hq, D) f32 over a linear cache. Dispatch by the layer state's
    keys: {"k", "v"} is the bf16 cache, {"k_q", "k_s", "v_q", "v_s"} the
    quantized one; `rows` ((B,) int32 or None) names the cache row of each
    sequence. CUDA tensors go through the kernel, CPU tensors through the
    plain version."""
    cpu = q.device.type == "cpu"
    if "k_q" in layer_state:
        fn = linear_attention_quant_plain if cpu else linear_attention_quant_kernel
        return fn(q, layer_state, q_positions, total_lens, k_bits, v_bits, compand_a,
                  rows=rows, **kw)
    fn = linear_attention_plain if cpu else linear_attention_kernel
    return fn(q, layer_state["k"], layer_state["v"], q_positions, total_lens, rows=rows, **kw)


# -- latent (MLA) cache -------------------------------------------------------------

def _latent_rows(t: torch.Tensor, B: int, block_tables=None, rows=None) -> torch.Tensor:
    """(B, T, ...) of a latent cache tensor, each sequence's keys in order:
    its pages through the block table (paged), or its row (linear: row b, or
    rows[b])."""
    if block_tables is not None:
        return t[block_tables.long()].reshape(B, -1, *t.shape[2:])
    return t[:B] if rows is None else t[rows.long()]


def _latent_dense(q, k, latent: int, q_positions, total_lens, scale: float) -> torch.Tensor:
    """Dense absorbed attention over gathered (B, T, 1, D) keys, V = the
    leading `latent` channels of each key; rows that see no key set to 0."""
    T = k.shape[1]
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)[None].expand(q.shape[0], T)
    o = attend_dense(q, k, k[..., :latent], q_positions, k_pos,
                     k_valid=k_pos < total_lens[:, None], scale=scale)
    valid = has_valid_key(q_positions, torch.clamp(total_lens, max=T))
    return o * valid[:, :, None, None].to(o.dtype)


# The latent decode kernel (csrc/latent_decode.cuh) serves S = 1: a block holds
# LATENT_ROWS heads of one token over a split of the keys, a power of two from
# LATENT_TILE keys, at most LATENT_MAX_SPLITS splits a (sequence, head slice),
# so that the grid (splits, head slices, B) holds about LATENT_BLOCKS_PER_SM
# blocks for each of the card's SMs. Over the ring and the pool (the TABLE
# layouts, which find a split's keys into a table in shared memory) a split
# holds at most LATENT_TABLE_KEYS keys. The limits are the header's own.
LATENT_ROWS, LATENT_TILE, LATENT_MAX_SPLITS, LATENT_TABLE_KEYS = header_constants(
    "latent_decode.cuh", "LAT_ROWS", "LAT_TILE", "LAT_MAX_SPLITS", "LAT_TABLE_KEYS")
LATENT_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)  # a served step asks for a few widths hundreds of times
def latent_split_keys(width: int, B: int, Hq: int, sms: int = H100_SMS,
                      table: bool = False) -> int:
    """Keys a split of the latent decode kernel covers, from widths the host
    knows: the layout's keys a sequence (the block table's width times 256,
    the linear cache's T, a ring's W or a pool's entries), the batch, the q
    heads and the card's SM count. Below a page it divides the page; above,
    it holds whole pages. With table (the ring, the pool) at most
    LATENT_TABLE_KEYS keys, so more splits than the grid asks for where the
    layout is wide: up to LATENT_MAX_SPLITS * LATENT_TABLE_KEYS keys a
    sequence, and a ValueError past that."""
    slices = -(-Hq // LATENT_ROWS)
    want = min(LATENT_MAX_SPLITS, max(1, -(-LATENT_BLOCKS_PER_SM * sms // (B * slices))))
    split = LATENT_TILE
    while -(-width // split) > want:
        split *= 2
    if table and split > LATENT_TABLE_KEYS:
        split = LATENT_TABLE_KEYS
        if -(-width // split) > LATENT_MAX_SPLITS:
            raise ValueError(f"{width} keys a sequence exceed the stats kernel's "
                             f"{LATENT_MAX_SPLITS} splits of {LATENT_TABLE_KEYS}")
    return split


# The latent prefill body (csrc/latent_prefill.cuh) serves every chunk of
# more than one token: a block holds LATENT_PREFILL_ROWS (token, head) rows
# and walks LATENT_PREFILL_TILE-key tiles. The two widths are the header's own.
LATENT_PREFILL_ROWS, LATENT_PREFILL_TILE = header_constants(
    "latent_prefill.cuh", "LP_ROWS", "LP_TK")
latent_attention_prefill = LaunchCount()
latent_attention_quant_prefill = LaunchCount()


def _latent_launch(q, width: int, sms: int, quant: bool, table: bool = False) -> tuple:
    """(workspace, counters, split_keys) of a latent launch: decode (S = 1)
    takes a workspace of (acc, m, l) for each split of latent_split_keys's
    size (the device's scratch: the launch's last split reads it, nothing
    after) and the arrival counters; a longer chunk takes a scratch for the
    prefill body's tiles of the keys the launch can see, the layout's width
    in whole LATENT_PREFILL_TILE-key tiles of bf16 rows: 576 values a key,
    1088 over the quantized latent (hi and lo). table: the ring's or the
    pool's split limit (latent_split_keys)."""
    B, S, Hq, _ = q.shape
    dev = q.device
    if S != 1:
        keys = -(-width // LATENT_PREFILL_TILE) * LATENT_PREFILL_TILE
        per_key = LATENT + ROPE + (LATENT if quant else 0)
        return torch.empty(B * keys * per_key, dtype=torch.bfloat16, device=dev), None, 0
    split_keys = latent_split_keys(width, B, Hq, sms, table)
    slices = -(-Hq // LATENT_ROWS)
    ws = scratch(dev, B * slices * -(-width // split_keys) * LATENT_ROWS * (LATENT + 2) * 4)
    return ws, arrival_counters(dev, B * slices), split_keys


def _latent_keys(q, layer_state: dict, block_tables, rows, k_bits: int, compand_a: float,
                 latent: int) -> tuple:
    """(q as the kernels score it, keys (B, T, 1, D), visible-by-layout
    (B, T) bool or None) of a latent cache, paged (with block_tables; a page
    out of range holds no visible key) or linear (rows, or rows 0..B-1):
    {"kv"} bf16 rows as they are and q as it is, or {"kv_q", "kv_s", "k_pe"}
    quantized: the latent dequantized to f32 in its rotated basis beside the
    rope key, and q rotated (rotate_latent_q)."""
    B = q.shape[0]
    quant = "kv_q" in layer_state
    names = ("kv_q", "kv_s", "k_pe") if quant else ("kv",)
    page_ok = None
    if block_tables is not None:
        ok = (block_tables >= 0) & (block_tables < layer_state[names[0]].shape[0])
        block_tables = torch.where(ok, block_tables, torch.zeros_like(block_tables))
        page_ok = ok.repeat_interleave(PAGE_SIZE, dim=1)
    parts = [_latent_rows(layer_state[n], B, block_tables, rows) for n in names]
    if not quant:
        return q, parts[0], page_ok
    k = torch.cat([dequantize_rotated(parts[0], parts[1], k_bits, compand_a),
                   parts[2].float()], dim=-1)
    return rotate_latent_q(q, latent), k, page_ok


def latent_attention_split_plain(q, layer_state: dict, q_positions, total_lens, latent: int,
                                 k_bits: int = 0, compand_a: float = 0.0, block_tables=None,
                                 rows=None, scale: float = 1.0,
                                 split_keys: int | None = None) -> torch.Tensor:
    """(B, 1, Hq, latent) f32: the latent decode kernel's arithmetic in plain
    torch (attention_split_plain with V = the leading `latent` channels of each
    key row), over a latent cache paged or linear (_latent_keys), {"kv"} bf16
    or {"kv_q", "kv_s", "k_pe"} quantized: the latter's q rotated as the kernel
    takes it, its latent dequantized to f32 in the rotated basis beside the
    rope key, and the output rotated back. The keys are cut by
    latent_split_keys at H100_SMS unless split_keys is given."""
    B, _, Hq, _ = q.shape
    qq, k, page_ok = _latent_keys(q, layer_state, block_tables, rows, k_bits, compand_a, latent)
    k = k[:, :, 0].float()  # (B, T, D): one row every head reads
    T = k.shape[1]
    vis = _causal_visible(q_positions, total_lens, T, q.device)
    if page_ok is not None:
        vis = vis & page_ok[:, None, :]
    o = attention_split_plain(qq.float(), k, k[..., :latent], vis,
                              split_keys or latent_split_keys(T, B, Hq), scale, rotate=False)
    return rotate_groups(o) if "kv_q" in layer_state else o


def _latent_prefill(q, layer_state: dict, q_positions, total_lens, latent: int, k_bits: int,
                    compand_a: float, block_tables, rows, scale: float) -> torch.Tensor:
    """The latent prefill body's arithmetic over either cache (_latent_keys):
    attention_prefill_plain at the body's geometry (LATENT_PREFILL_ROWS rows,
    LATENT_PREFILL_TILE-key tiles, one kv head), V the leading `latent`
    channels of each key row; over the quantized latent the output rotated
    back."""
    qq, k, page_ok = _latent_keys(q, layer_state, block_tables, rows, k_bits, compand_a, latent)
    vis = _causal_visible(q_positions, total_lens, k.shape[1], q.device)
    if page_ok is not None:
        vis = vis & page_ok[:, None, :]
    o = attention_prefill_plain(qq, k, k[..., :latent], vis, scale, rows=LATENT_PREFILL_ROWS,
                                tile=LATENT_PREFILL_TILE)
    return rotate_groups(o) if "kv_q" in layer_state else o


def latent_attention_prefill_plain(q, kv, q_positions, total_lens, latent: int,
                                   block_tables=None, rows=None,
                                   scale: float = 1.0) -> torch.Tensor:
    """(B, S, Hq, latent) f32 over a bf16 latent cache, as
    latent_attention_plain takes it, by the latent prefill body's arithmetic
    (csrc/latent_prefill.cuh): q bf16 in one product, P as hi + lo bf16
    pairs, the online softmax by 32-key tiles over q blocks of 64 rows."""
    return _latent_prefill(q, {"kv": kv}, q_positions, total_lens, latent, 0, 0.0, block_tables,
                           rows, scale)


def latent_attention_quant_prefill_plain(q, layer_state: dict, q_positions, total_lens,
                                         k_bits: int, compand_a: float = 0.0,
                                         block_tables=None, rows=None,
                                         scale: float = 1.0) -> torch.Tensor:
    """(B, S, Hq, c) f32 over a quantized latent cache, as
    latent_attention_quant_plain takes it, by the latent prefill body's
    arithmetic: q rotated (rotate_latent_q) and bf16, the latent's values in
    the rotated basis as exact hi + lo bf16 pairs (the rope key's lo 0), the
    scores q.K hi + q.K lo, P.V as P hi.V hi + P lo.V hi + P hi.V lo (lo.lo
    left out), and the output rotated back."""
    c = layer_state["kv_s"].shape[-1] * 32
    return _latent_prefill(q, layer_state, q_positions, total_lens, c, k_bits, compand_a,
                           block_tables, rows, scale)


def latent_attention_plain(q, kv, q_positions, total_lens, latent: int, block_tables=None,
                           rows=None, scale: float = 1.0) -> torch.Tensor:
    """(B, S, Hq, latent) f32 over a bf16 latent cache kv, paged
    (P, 256, 1, D) with block_tables or linear (N, T, 1, D) with rows (or
    rows 0..B-1): each row of kv is [c_kv | k_pe], V its leading `latent`
    channels. q (B, S, Hq, D) as the MLA module hands it over."""
    k = _latent_rows(kv, q.shape[0], block_tables, rows).float()
    return _latent_dense(q, k, latent, q_positions, total_lens, scale)


def _latent_args(name: str, q, tensors: tuple, block_tables, rows, q_positions, total_lens):
    """Checks common to both latent kernels; the paged or linear arguments
    (bt, rows, MP, P, N, T) of the launch."""
    B, S, Hq, D = q.shape
    cache = tensors[0]
    ints = (q_positions, total_lens) + ((block_tables,) if block_tables is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in (q,) + tensors + ints):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if q.dtype != torch.bfloat16 or any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: expected bf16 q, int32 tables, positions and lengths")
    if (D != LATENT + ROPE or cache.dim() != 4 or cache.shape[2] != 1
            or q_positions.shape != (B, S) or total_lens.shape != (B,)
            or (block_tables is not None and (block_tables.shape[0] != B
                                              or cache.shape[1] != PAGE_SIZE))):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"cache {tuple(cache.shape)}")
    if not all(t.is_contiguous() for t in (q,) + tensors + ints):
        raise ValueError(f"{name}: tensors must be contiguous")
    check_aligned(name, q, *tensors)
    N, T = cache.shape[:2]
    if block_tables is not None:
        return block_tables.data_ptr(), None, block_tables.shape[1], N, 0, 0
    return None, _linear_rows(rows, B, N, q.device), 0, 0, N, T


def latent_attention_kernel(q, kv, q_positions, total_lens, block_tables=None, rows=None,
                            scale: float = 1.0) -> torch.Tensor:
    """Launch csrc/latent_attention.cu. q (B, S, Hq, 576) bf16; kv bf16,
    paged (P, 256, 1, 576) with block_tables (B, MP) int32, or linear
    (N, T, 1, 576) with rows (B,) int32 or None; q_positions (B, S) and
    total_lens (B,) int32; any Hq. -> (B, S, Hq, 512) f32. Decode (S = 1)
    runs the split-key kernel (splits sized by latent_split_keys for this
    card), a longer chunk the prefill body of csrc/latent_prefill.cuh (its
    pre-pass, then the body), whose launches latent_attention_prefill also
    counts."""
    B, S, Hq, _ = q.shape
    if kv.dtype != torch.bfloat16 or kv.shape[-1] != LATENT + ROPE:
        raise TypeError("latent_attention_kernel: expected a bf16 (., ., 1, 576) latent cache")
    bt, rp, MP, P, N, T = _latent_args("latent_attention_kernel", q, (kv,), block_tables, rows,
                                       q_positions, total_lens)
    ws, counters, split_keys = _latent_launch(q, MP * PAGE_SIZE or T, device_sms(q.device), False)
    out = torch.empty((B, S, Hq, LATENT), dtype=torch.float32, device=q.device)
    err = library().exl3_latent_attention(
        q.data_ptr(), kv.data_ptr(), bt, rp, q_positions.data_ptr(), total_lens.data_ptr(),
        out.data_ptr(), _ptr(ws), _ptr(counters), B, S, Hq, MP, P, N, T, float(scale), split_keys,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_latent_attention", err)
    latent_attention_kernel.launches += 1
    if S > 1:
        latent_attention_prefill.launches += 1
    return out


latent_attention_kernel.launches = 0


def rotate_latent_q(q: torch.Tensor, latent: int) -> torch.Tensor:
    """bf16 q with its leading `latent` channels rotated per 32-channel group
    (in f32, then rounded to bf16, as the JAX package rounds its rotated q)
    and the rope channels as they are: the q that scores against the stored,
    rotated latent."""
    qf = q.float()
    return torch.cat([rotate_groups(qf[..., :latent]), qf[..., latent:]], dim=-1).to(torch.bfloat16)


def latent_attention_quant_plain(q, layer_state: dict, q_positions, total_lens, k_bits: int,
                                 compand_a: float = 0.0, block_tables=None, rows=None,
                                 scale: float = 1.0) -> torch.Tensor:
    """(B, S, Hq, c) f32 over a quantized latent cache {kv_q int32 words,
    kv_s bf16 scales, k_pe bf16}, paged or linear as latent_attention_plain:
    q rotated as the kernel takes it (rotate_latent_q), the latent dequantized
    to f32 in its rotated basis beside the rope key, dense attention, and the
    output rotated back."""
    c = layer_state["kv_s"].shape[-1] * 32
    B = q.shape[0]
    words, scales, k_pe = (_latent_rows(layer_state[n], B, block_tables, rows)
                           for n in ("kv_q", "kv_s", "k_pe"))
    k = torch.cat([dequantize_rotated(words, scales, k_bits, compand_a), k_pe.float()], dim=-1)
    o = _latent_dense(rotate_latent_q(q, c), k, c, q_positions, total_lens, scale)
    return rotate_groups(o)


def latent_attention_quant_kernel(q, layer_state: dict, q_positions, total_lens, k_bits: int,
                                  compand_a: float = 0.0, block_tables=None, rows=None,
                                  scale: float = 1.0) -> torch.Tensor:
    """Launch csrc/latent_attention_quant.cu. q (B, S, Hq, 576) bf16;
    layer_state {kv_q (., ., 1, 16 * k_bits) int32, kv_s (., ., 1, 16) bf16,
    k_pe (., ., 1, 64) bf16}, paged with block_tables or linear with rows, as
    latent_attention_kernel; k_bits in 2..8. Decode (S = 1) runs the
    split-key kernel, which rotates q's latent per 32-channel group (and
    rounds it to bf16) and the output back itself; a longer chunk takes the
    prefill body of csrc/latent_prefill.cuh, whose pre-pass dequantizes the
    keys the launch can see into a scratch (B x the layout's width x 1088
    bf16, 71 MB for one sequence of 32K keys; launches counted by
    latent_attention_quant_prefill too), q rotated before the launch and the
    output after it."""
    B, S, Hq, _ = q.shape
    kq, ks, kpe = (layer_state[n] for n in ("kv_q", "kv_s", "k_pe"))
    lead = kq.shape[:3]
    if (kq.dtype != torch.int32 or ks.dtype != torch.bfloat16 or kpe.dtype != torch.bfloat16
            or not 2 <= k_bits <= 8 or kq.shape[-1] != LATENT * k_bits // 32
            or ks.shape != (*lead, LATENT // 32) or kpe.shape != (*lead, ROPE)):
        raise ValueError(f"latent_attention_quant_kernel: unsupported state "
                         f"kv_q {tuple(kq.shape)} {kq.dtype}, k_pe {tuple(kpe.shape)}, "
                         f"bits {k_bits}")
    qr = q if S == 1 else rotate_latent_q(q, LATENT)
    bt, rp, MP, P, N, T = _latent_args("latent_attention_quant_kernel", qr, (kq, ks, kpe),
                                       block_tables, rows, q_positions, total_lens)
    ws, counters, split_keys = _latent_launch(q, MP * PAGE_SIZE or T, device_sms(q.device), True)
    out = torch.empty((B, S, Hq, LATENT), dtype=torch.float32, device=q.device)
    err = library().exl3_latent_attention_quant(
        qr.data_ptr(), kq.data_ptr(), ks.data_ptr(), kpe.data_ptr(), bt, rp,
        q_positions.data_ptr(), total_lens.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(counters),
        B, S, Hq, MP, P, N, T, int(k_bits), float(compand_a), float(1.0 - compand_a),
        float(scale), split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_latent_attention_quant", err)
    latent_attention_quant_kernel.launches += 1
    if S == 1:
        return out
    latent_attention_quant_prefill.launches += 1
    return rotate_groups(out)


latent_attention_quant_kernel.launches = 0


def latent_attention_any(q, layer_state: dict, q_positions, total_lens, latent: int,
                         k_bits: int = 0, compand_a: float = 0.0, block_tables=None, rows=None,
                         scale: float = 1.0) -> torch.Tensor:
    """(B, S, Hq, latent) f32 over a latent cache, paged (with block_tables)
    or linear (with rows, or rows 0..B-1). Dispatch by the layer state's keys:
    {"kv"} is the bf16 cache, {"kv_q", "kv_s", "k_pe"} the quantized one; CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    cpu = q.device.type == "cpu"
    if not cpu and latent != LATENT:
        raise ValueError(f"latent_attention: the kernels take a latent of {LATENT}, not {latent}")
    kw = dict(block_tables=block_tables, rows=rows, scale=scale)
    if "kv_q" in layer_state:
        fn = latent_attention_quant_plain if cpu else latent_attention_quant_kernel
        return fn(q, layer_state, q_positions, total_lens, k_bits, compand_a, **kw)
    if cpu:
        return latent_attention_plain(q, layer_state["kv"], q_positions, total_lens, latent, **kw)
    return latent_attention_kernel(q, layer_state["kv"], q_positions, total_lens, **kw)


# -- SWA ring ------------------------------------------------------------------------

def ring_visible(ring_pos, q_positions, sliding_window: int = 0) -> torch.Tensor:
    """(B, S, W) bool: slot j of each sequence's ring rows `ring_pos` (B, W)
    is visible to the query at q_positions (B, S): 0 <= pos[j] <= q_pos and,
    with a window, pos[j] > q_pos - window."""
    kp, qp = ring_pos[:, None, :], q_positions[:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    if sliding_window:
        vis &= kp > qp - sliding_window
    return vis


def ring_attention_plain(q, ring_k, ring_v, ring_pos, slots, q_positions, sinks=None,
                         scale: float = 1.0, sliding_window: int = 0,
                         logit_softcap: float = 0.0) -> torch.Tensor:
    """(B, 1, Hq, D) f32: each sequence's ring row slots[b] gathered, masked by
    its stored positions, and the softmax taken in f32; rows that see no slot
    set to 0. q (B, 1, Hq, D) f32; ring_k, ring_v (N, W, Hk, D) bf16;
    ring_pos (N, W) int32; slots (B,) int32; q_positions (B, 1) int32."""
    rows = slots.long()
    pos = ring_pos[rows]
    o = attend_dense(q, ring_k[rows], ring_v[rows], q_positions, pos, k_valid=pos >= 0,
                     scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
                     sinks=sinks)
    valid = ring_visible(pos, q_positions, sliding_window).any(dim=-1)
    return o * valid[:, :, None, None].to(o.dtype)


def ring_attention_split_plain(q, ring_k, ring_v, ring_pos, slots, q_positions, sinks=None,
                               scale: float = 1.0, sliding_window: int = 0,
                               logit_softcap: float = 0.0,
                               split_keys: int | None = None) -> torch.Tensor:
    """(B, 1, Hq, D) f32 over the ring by the decode kernel's split
    arithmetic (attention_split_plain without rotation, K/V as f32, ring_visible
    as the mask): the W slots of each sequence's ring row cut into splits of
    decode_split_keys(W) at H100_SMS unless split_keys is given, every split
    taking part; a ring row out of range holds no visible slot."""
    B, Hk = q.shape[0], ring_k.shape[2]
    N, W = ring_pos.shape
    ok = (slots >= 0) & (slots < N)
    rows = torch.where(ok, slots, torch.zeros_like(slots)).long()
    pos = ring_pos[rows]
    vis = ring_visible(pos, q_positions, sliding_window) & ok[:, None, None]
    return attention_split_plain(q, ring_k[rows].float(), ring_v[rows].float(), vis,
                                 split_keys or decode_split_keys(W, B, Hk), scale,
                                 logit_softcap, sinks, rotate=False)


def ring_attention_kernel(q, ring_k, ring_v, ring_pos, slots, q_positions, sinks=None,
                          scale: float = 1.0, sliding_window: int = 0,
                          logit_softcap: float = 0.0) -> torch.Tensor:
    """Launch csrc/ring_attention.cu: decode (S = 1). q (B, 1, Hq, D) f32;
    ring_k, ring_v (N, W, Hk, D) bf16; ring_pos (N, W), slots (B,) and
    q_positions (B, 1) int32; sinks (Hq,) f32 or None; D in {64, 128}, any
    GQA group, any W (up to RING_MAX_SLOTS for a group of up to DECODE_ROWS
    heads, which the split-key decode kernel serves, splits sized by
    decode_split_keys over W for this card; wider groups take the tile
    loop)."""
    B, S, Hq, D = q.shape
    N, W, Hk, Dk = ring_k.shape
    ints = (ring_pos, slots, q_positions)
    tensors = (q, ring_k, ring_v) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("ring_attention_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or ring_k.dtype != torch.bfloat16
            or ring_v.dtype != torch.bfloat16 or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("ring_attention_kernel: expected f32 q, bf16 ring k/v, int32 positions "
                        "and slots, f32 sinks")
    if (S != 1 or Dk != D or ring_v.shape != ring_k.shape or D not in (64, 128) or W < 1
            or Hq % Hk or ring_pos.shape != (N, W) or slots.shape != (B,)
            or q_positions.shape != (B, 1) or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"ring_attention_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"ring {tuple(ring_k.shape)}, pos {tuple(ring_pos.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring_attention_kernel: tensors must be contiguous")
    if Hq // Hk <= DECODE_ROWS and W > RING_MAX_SLOTS:
        raise ValueError(f"ring_attention_kernel: a ring of {W} slots exceeds the decode "
                         f"kernel's {RING_MAX_SLOTS}")
    check_aligned("ring_attention_kernel", q, ring_k, ring_v)
    _, ws, counters, split_keys = _decode_launch(q, Hk, W, device_sms(q.device), rotate=False)
    out = torch.empty((B, 1, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_ring_attention(
        q.data_ptr(), ring_k.data_ptr(), ring_v.data_ptr(), ring_pos.data_ptr(),
        slots.data_ptr(), q_positions.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(), _ptr(ws),
        _ptr(counters), B, Hq, Hk, D, N, W, float(scale), int(sliding_window),
        float(logit_softcap), split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_ring_attention", err)
    ring_attention_kernel.launches += 1
    return out


ring_attention_kernel.launches = 0


def ring_attention(q, ring_k, ring_v, ring_pos, slots, q_positions, sinks=None,
                   scale: float = 1.0, sliding_window: int = 0,
                   logit_softcap: float = 0.0) -> torch.Tensor:
    """(B, 1, Hq, D) f32, decode over the SWA ring (the JAX package's
    flash_ring_attention). CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    fn = ring_attention_plain if q.device.type == "cpu" else ring_attention_kernel
    return fn(q, ring_k, ring_v, ring_pos, slots, q_positions, sinks=sinks, scale=scale,
              sliding_window=sliding_window, logit_softcap=logit_softcap)


# -- return_stats: DeepSeek-V4's decode over one shared K = V row -----------------------

NEG_INF = -1e30  # the JAX kernel's start of m: a row that saw no key
# the stats kernels' row (DeepSeek-V4's head_dim): the header's own
KV_ROW = header_constants("latent_decode.cuh", "KV_ROW")[0]


def merge_splits(parts) -> tuple:
    """(acc, m, l) of several key splits' (acc, m, l), as the stats kernel
    merges them: m the largest split's, each split weighed by exp(m_s - m)
    (0 for a split that saw no key) and added in split order; a row no split
    saw gives (0, -1e30, 0)."""
    mg = parts[0][1]
    for _, mp, _ in parts[1:]:
        mg = torch.maximum(mg, mp)
    acc, l = 0.0, 0.0
    for ap, mp, lp in parts:
        c = torch.where(mp <= NEG_INF / 2, torch.zeros_like(mp), torch.exp(mp - mg))
        acc = acc + ap * c[..., None]
        l = l + lp * c
    return acc, mg, l


def attend_stats_plain(q, k, visible, scale: float, v=None,
                       logit_softcap: float = 0.0, split_keys: int | None = None) -> tuple:
    """(acc (B, S, Hq, D), m (B, S, Hq), l (B, S, Hq)) f32 over gathered keys,
    visible (B, S, T) bool: k (B, T, D), one row every head reads, or
    (B, T, Hk, D), q head h reading kv head h // (Hq / Hk); v shaped as k, or
    None when V is K. m is the largest visible score (scale * q.k, then the
    softcap), l = sum exp(s - m), acc = sum exp(s - m) * v; a row that sees
    no key gives (0, -1e30, 0). With split_keys, the stats kernel's
    arithmetic: the keys cut into splits of that many, each split's (acc, m,
    l) merged in split order (merge_splits)."""
    if split_keys is not None:
        return merge_splits([
            attend_stats_plain(q, k[:, k0:k0 + split_keys], visible[..., k0:k0 + split_keys], scale,
                               None if v is None else v[:, k0:k0 + split_keys], logit_softcap)
            for k0 in range(0, k.shape[1], split_keys)])
    kf = k.float()
    vf = kf if v is None else v.float()
    if kf.dim() == 3:
        s = torch.einsum("bshd,btd->bsht", q.float(), kf) * scale
    else:
        G = q.shape[2] // kf.shape[2]
        kf, vf = kf.repeat_interleave(G, dim=2), vf.repeat_interleave(G, dim=2)
        s = torch.einsum("bshd,bthd->bsht", q.float(), kf) * scale
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    s = torch.where(visible[:, :, None, :], s, torch.full_like(s, -torch.inf))
    m = s.amax(dim=-1)
    seen = torch.isfinite(m)
    p = torch.exp(s - torch.where(seen, m, torch.zeros_like(m))[..., None])
    acc = torch.einsum("bsht,btd->bshd" if vf.dim() == 3 else "bsht,bthd->bshd", p, vf)
    return acc, torch.where(seen, m, torch.full_like(m, NEG_INF)), p.sum(dim=-1)


def merge_stats(parts, sinks=None) -> torch.Tensor:
    """One softmax over several key sources and a per-head sink logit
    (modules/dsv4_attn.py's epilogue in the JAX package): parts a list of
    (acc (B, S, H, D), m (B, S, H), l (B, S, H)); sinks (H,) f32, or None for
    no sink. A part whose m is NEG_INF saw no key and adds nothing; a row no
    part saw gives 0. -> (B, S, H, D) f32."""
    mg = None if sinks is None else sinks.float()[None, None, :]
    for _, mp, _ in parts:
        mg = mp if mg is None else torch.maximum(mg, mp)
    lg = torch.zeros_like(mg) if sinks is None else torch.exp(sinks.float()[None, None, :] - mg)
    acc = 0.0
    for ap, mp, lp in parts:
        c = torch.where(mp <= NEG_INF / 2, torch.zeros_like(mp), torch.exp(mp - mg))
        lg = lg + lp * c
        acc = acc + ap * c[..., None]
    return acc / torch.clamp(lg, min=1e-30)[..., None]


def _stats_launch(q, width: int, table: bool) -> tuple:
    """(acc, m, l, workspace, counters, split_keys) of a stats launch over a
    layout of `width` keys a sequence (table: the ring or the pool): the
    outputs, and the latent decode kernel's workspace, arrival counters and
    split size (_latent_launch)."""
    B, S, Hq, D = q.shape
    dev = q.device
    ws, counters, split_keys = _latent_launch(q, width, device_sms(dev), False, table)
    return (torch.empty((B, S, Hq, D), dtype=torch.float32, device=dev),
            torch.empty((B, S, Hq), dtype=torch.float32, device=dev),
            torch.empty((B, S, Hq), dtype=torch.float32, device=dev),
            ws, counters, split_keys)


def _stats_check(name: str, q, store, ints: tuple) -> None:
    """Checks common to the three stats kernels: decode q (B, 1, Hq, 512) bf16,
    a bf16 store of 512-wide rows, int32 indices, one CUDA device, contiguous."""
    tensors = (q, store) + ints
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if (q.dtype != torch.bfloat16 or store.dtype != torch.bfloat16
            or any(t.dtype != torch.int32 for t in ints)):
        raise TypeError(f"{name}: expected bf16 q and rows, int32 indices")
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != KV_ROW or store.shape[-1] != KV_ROW:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"rows {tuple(store.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    check_aligned(name, q, store)


def ring_attention_stats_plain(q, ring_kv, ring_pos, slots, q_positions, scale: float = 1.0,
                               sliding_window: int = 0, split_keys: int | None = None) -> tuple:
    """(acc, m, l) over each sequence's ring row slots[b] of ring_kv (N, W, D),
    K and V alike, visible by stored position (ring_visible); a ring row out
    of range holds no visible slot. With split_keys, the W slots cut into
    splits as the kernel cuts them (attend_stats_plain)."""
    N = ring_pos.shape[0]
    ok = (slots >= 0) & (slots < N)
    rows = torch.where(ok, slots, torch.zeros_like(slots)).long()
    vis = ring_visible(ring_pos[rows], q_positions, sliding_window) & ok[:, None, None]
    return attend_stats_plain(q, ring_kv[rows], vis, scale, split_keys=split_keys)


def ring_attention_stats_kernel(q, ring_kv, ring_pos, slots, q_positions, scale: float = 1.0,
                                sliding_window: int = 0) -> tuple:
    """Launch exl3_ring_attention_stats (csrc/attention_stats.cu). q (B, 1, Hq,
    512) bf16; ring_kv (N, W, 512) bf16; ring_pos (N, W), slots (B,) and
    q_positions (B, 1) int32. One launch of the latent decode kernel, the W
    slots cut by latent_split_keys for this card."""
    B, _, Hq, _ = q.shape
    N, W = ring_pos.shape
    _stats_check("ring_attention_stats_kernel", q, ring_kv, (ring_pos, slots, q_positions))
    if (ring_kv.shape != (N, W, KV_ROW) or W < 1 or slots.shape != (B,)
            or q_positions.shape != (B, 1)):
        raise ValueError(f"ring_attention_stats_kernel: unsupported shapes ring "
                         f"{tuple(ring_kv.shape)}, pos {tuple(ring_pos.shape)}")
    acc, m, l, ws, counters, split_keys = _stats_launch(q, W, True)
    err = library().exl3_ring_attention_stats(
        q.data_ptr(), ring_kv.data_ptr(), ring_pos.data_ptr(), slots.data_ptr(),
        q_positions.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), B, Hq, N, W, float(scale), int(sliding_window), split_keys,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_ring_attention_stats", err)
    ring_attention_stats_kernel.launches += 1
    return acc, m, l


ring_attention_stats_kernel.launches = 0


def ring_attention_stats(q, ring_kv, ring_pos, slots, q_positions, scale: float = 1.0,
                         sliding_window: int = 0) -> tuple:
    """(acc, m, l) of decode over the sliding ring (the JAX package's
    flash_ring_attention with return_stats). CUDA tensors go through the
    kernel, CPU tensors through the plain version."""
    fn = ring_attention_stats_plain if q.device.type == "cpu" else ring_attention_stats_kernel
    return fn(q, ring_kv, ring_pos, slots, q_positions, scale=scale,
              sliding_window=sliding_window)


def _pool_keys(pool, block_tables) -> tuple:
    """((B, MP * epp, D) entries, (B, MP * epp) bool page in range) of a pool
    (P, epp, D) paged through the block tables; entry j of sequence b is slot
    j % epp of page block_tables[b, j // epp]."""
    P = pool.shape[0]
    bt = block_tables.long()
    ok = (bt >= 0) & (bt < P)
    g = pool[torch.where(ok, bt, torch.zeros_like(bt))]
    B = bt.shape[0]
    return g.reshape(B, -1, pool.shape[-1]), ok.repeat_interleave(pool.shape[1], dim=1)


def _causal_visible(q_positions, total_lens, T: int, device,
                    sliding_window: int = 0) -> torch.Tensor:
    """(B, S, T) bool: key j visible iff j < total_len, j <= q_position and,
    with a window, j > q_position - window."""
    j = torch.arange(T, device=device)[None, None, :]
    qp = q_positions[:, :, None]
    vis = (j < total_lens[:, None, None]) & (j <= qp)
    return vis & (j > qp - sliding_window) if sliding_window else vis


def pool_attention_stats_plain(q, pool, block_tables, q_positions, total_lens,
                               scale: float = 1.0, split_keys: int | None = None) -> tuple:
    """(acc, m, l) over a compressed pool (P, epp, D), K and V alike, paged
    through the token block tables with epp entries a page. With split_keys,
    the entries cut into splits as the kernel cuts them
    (attend_stats_plain)."""
    k, ok = _pool_keys(pool, block_tables)
    vis = _causal_visible(q_positions, total_lens, k.shape[1], q.device) & ok[:, None, :]
    return attend_stats_plain(q, k, vis, scale, split_keys=split_keys)


def pool_attention_stats_kernel(q, pool, block_tables, q_positions, total_lens,
                                scale: float = 1.0) -> tuple:
    """Launch exl3_pool_attention_stats (csrc/attention_stats.cu). q (B, 1, Hq,
    512) bf16; pool (P, epp, 512) bf16, any epp; block_tables (B, MP),
    q_positions (B, 1) and total_lens (B,) int32. One launch of the latent
    decode kernel, the MP * epp entries cut by latent_split_keys for this
    card."""
    B, _, Hq, _ = q.shape
    _stats_check("pool_attention_stats_kernel", q, pool, (block_tables, q_positions, total_lens))
    P, epp = pool.shape[:2]
    if (pool.dim() != 3 or epp < 1 or block_tables.dim() != 2 or block_tables.shape[0] != B
            or q_positions.shape != (B, 1) or total_lens.shape != (B,)):
        raise ValueError(f"pool_attention_stats_kernel: unsupported shapes pool "
                         f"{tuple(pool.shape)}, tables {tuple(block_tables.shape)}")
    MP = block_tables.shape[1]
    acc, m, l, ws, counters, split_keys = _stats_launch(q, MP * epp, True)
    err = library().exl3_pool_attention_stats(
        q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(), q_positions.data_ptr(),
        total_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), B, Hq, MP, P, epp, float(scale), split_keys,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_pool_attention_stats", err)
    pool_attention_stats_kernel.launches += 1
    return acc, m, l


pool_attention_stats_kernel.launches = 0


def pool_attention_stats(q, pool, block_tables, q_positions, total_lens,
                         scale: float = 1.0) -> tuple:
    """(acc, m, l) of decode over a paged compressed pool (the JAX package's
    flash_attention with `latent` and return_stats over the HCA pool). CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    fn = pool_attention_stats_plain if q.device.type == "cpu" else pool_attention_stats_kernel
    return fn(q, pool, block_tables, q_positions, total_lens, scale=scale)


def rows_attention_stats_plain(q, kv, q_positions, total_lens, scale: float = 1.0,
                               split_keys: int | None = None) -> tuple:
    """(acc, m, l) over each sequence's own rows kv (B, T, D), K and V alike.
    With split_keys, the T rows cut into splits as the kernel cuts them
    (attend_stats_plain)."""
    vis = _causal_visible(q_positions, total_lens, kv.shape[1], q.device)
    return attend_stats_plain(q, kv, vis, scale, split_keys=split_keys)


def rows_attention_stats_kernel(q, kv, q_positions, total_lens, scale: float = 1.0) -> tuple:
    """Launch exl3_rows_attention_stats (csrc/attention_stats.cu). q (B, 1, Hq,
    512) bf16; kv (B, T, 512) bf16, any T; q_positions (B, 1) and total_lens
    (B,) int32. One launch of the latent decode kernel, the T rows cut by
    latent_split_keys for this card."""
    B, _, Hq, _ = q.shape
    _stats_check("rows_attention_stats_kernel", q, kv, (q_positions, total_lens))
    if kv.dim() != 3 or kv.shape[0] != B or kv.shape[1] < 1 or q_positions.shape != (B, 1) \
            or total_lens.shape != (B,):
        raise ValueError(f"rows_attention_stats_kernel: unsupported shapes kv {tuple(kv.shape)}")
    T = kv.shape[1]
    acc, m, l, ws, counters, split_keys = _stats_launch(q, T, False)
    err = library().exl3_rows_attention_stats(
        q.data_ptr(), kv.data_ptr(), q_positions.data_ptr(), total_lens.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Hq, T,
        float(scale), split_keys, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_rows_attention_stats", err)
    rows_attention_stats_kernel.launches += 1
    return acc, m, l


rows_attention_stats_kernel.launches = 0


def rows_attention_stats(q, kv, q_positions, total_lens, scale: float = 1.0) -> tuple:
    """(acc, m, l) of decode over selected entries gathered into rows (the JAX
    package's flash_attention with `latent` and return_stats over the CSA
    top-k, linear layout). CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    fn = rows_attention_stats_plain if q.device.type == "cpu" else rows_attention_stats_kernel
    return fn(q, kv, q_positions, total_lens, scale=scale)
