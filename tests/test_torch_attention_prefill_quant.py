"""The prefill body (csrc/attention_prefill.cuh) over the quantized cache on
the CPU: its plain arithmetic (attention_prefill_plain over the rotated values
the kernel unpacks, K/V entering the products as hi + lo bf16 pairs beside q
and P, the lo.lo term left out), through paged_attention_quant_prefill_plain
and linear_attention_quant_prefill_plain, against the JAX package's
flash_attention with k_bits / v_bits in interpret mode over the same numpy
inputs: the paged and the linear layout, merged (4, 4), (2, 2) and (8, 8)
and per-head (5, 3) and (3, 7) storage, the compander at 0.65, D = 64 and
128, GQA groups 1, 5 and 8, a chunk that starts mid-page, window + softcap +
sinks with padded rows, a sequence that sees no key, linear rows with T no
multiple of 64 (named rows among them). Every case has more than
DECODE_ROWS rows a kv head. The CUDA body is held against the plain versions
on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops import kv_quant as jq
from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import flash_attention as F


def _state(rng, lead: tuple, Hk: int, D: int, k_bits: int, v_bits: int, a: float) -> tuple:
    """(JAX layer state, the port's) of random keys and values quantized by
    the JAX package, in the storage its widths choose."""
    merged = jq.merged_layout(k_bits, v_bits)
    jstate = {}
    for name, bits in (("k", k_bits), ("v", v_bits)):
        x = rng.standard_normal((*lead, Hk, D)).astype(np.float32)
        jstate[name + "_q"], jstate[name + "_s"] = jq.quantize_kv_stored(jnp.asarray(x), bits,
                                                                        merged, a)
    tstate = {n: (torch.from_numpy(np.array(t)) if n.endswith("_q") else
                  torch.from_numpy(np.asarray(t).view(np.int16).copy()).view(torch.bfloat16))
              for n, t in jstate.items()}
    return jstate, tstate


def _chunk(starts, S: int, pad: int = 0) -> np.ndarray:
    """(B, S) q positions: S consecutive positions from each start, the last
    `pad` of each row a padded slot at position 4096."""
    pos = np.array([np.arange(s, s + S) for s in starts], np.int32)
    if pad:
        pos[:, S - pad:] = 4096
    return pos


# (layout, (k_bits, v_bits), compand_a, D, (Hq, Hk), q positions, total
#  lengths, block table or (rows, N, T), features)
CASES = {
    # merged (4, 4) at 128-wide heads, group 8: a prompt from position 0,
    # 320 rows, three q blocks
    "paged-4-4-d128-group8-prompt": (
        "paged", (4, 4), 0.0, 128, (16, 2), _chunk([0], 40), [40], [[1, 0]], {}),
    # per-head (5, 3), group 1: 40 rows, the chunk starts mid-page (300 =
    # page 1 + 44) and ends in the page after
    "paged-5-3-d64-group1-mid-page": (
        "paged", (5, 3), 0.0, 64, (4, 4), _chunk([300], 40), [340], [[3, 0, 2]], {}),
    # merged (2, 2), group 5, a window of 100, a softcap of 20 and sinks; the
    # last 4 rows are padded slots past the sequence, out of the window's reach
    "paged-2-2-d64-group5-window-softcap-sinks-padded": (
        "paged", (2, 2), 0.0, 64, (10, 2), _chunk([500], 20, pad=4), [516], [[2, 0, 1]],
        {"sliding_window": 100, "logit_softcap": 20.0, "sinks": True}),
    # merged (8, 8), the widest words, group 5; sequence 1 has no key at all
    # (total length 0)
    "paged-8-8-d128-group5-sequence-without-keys": (
        "paged", (8, 8), 0.0, 128, (10, 2), _chunk([250, 0], 10), [260, 0], [[1, 2], [3, 0]],
        {}),
    # per-head (3, 7) with the compander, group 8, two sequences of unequal
    # length whose chunks start mid-page
    "paged-3-7-compand-d64-group8-two-sequences": (
        "paged", (3, 7), 0.65, 64, (16, 2), _chunk([100, 400], 12), [112, 412],
        [[2, 0], [1, 3]], {}),
    # named rows of a 5-row cache of T = 200 slots (no multiple of 64: the
    # last tile is cut), merged (4, 4), group 8, with sinks
    "linear-4-4-d128-group8-named-rows-T200": (
        "linear", (4, 4), 0.0, 128, (16, 2), _chunk([150, 30], 20), [170, 50], ([3, 1], 5, 200),
        {"sinks": True}),
    # per-head (5, 3), group 1 over T = 136 with a window of 50 and a softcap
    "linear-5-3-d64-group1-window-softcap-T136": (
        "linear", (5, 3), 0.0, 64, (2, 2), _chunk([96], 40), [136], (None, 1, 136),
        {"sliding_window": 50, "logit_softcap": 30.0}),
    # per-head (3, 7) with the compander, group 5, two sequences of unequal
    # length over T = 264
    "linear-3-7-compand-d64-group5-T264": (
        "linear", (3, 7), 0.65, 64, (10, 2), _chunk([200, 40], 16), [216, 56], (None, 2, 264),
        {}),
}

EMPTY_ROW_CASES = ("paged-2-2-d64-group5-window-softcap-sinks-padded",
                   "paged-8-8-d128-group5-sequence-without-keys")


@pytest.mark.parametrize("case", list(CASES))
def test_quant_prefill_plain_matches_jax_kernel(case):
    layout, (kb, vb), a, D, (Hq, Hk), qpos, total, where, feats = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    total = np.array(total, np.int32)
    B, S = qpos.shape
    assert F.attention_route(S, Hq, Hk) == "prefill"
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    sinks = rng.standard_normal(Hq).astype(np.float32) if feats.get("sinks") else None
    kw = dict(scale=D ** -0.5, sliding_window=feats.get("sliding_window", 0),
              logit_softcap=feats.get("logit_softcap", 0.0))
    tkw = dict(kw, sinks=None if sinks is None else torch.from_numpy(sinks))
    tq, tpos, ttot = torch.from_numpy(q), torch.from_numpy(qpos), torch.from_numpy(total)
    if layout == "paged":
        bt = np.array(where, np.int32)
        jstate, tstate = _state(rng, (int(bt.max()) + 1, PAGE_SIZE), Hk, D, kb, vb, a)
        jbt = jnp.asarray(bt)
        targs = (tq, tstate, torch.from_numpy(bt), tpos, ttot, kb, vb, a)
        got = F.paged_attention_quant_prefill_plain(*targs, **tkw)
        whole = F.paged_attention_quant_plain(*targs, **tkw)
    else:
        rows, N, T = where
        jstate, tstate = _state(rng, (N, T), Hk, D, kb, vb, a)
        jbt = None
        if rows is not None:  # JAX reads the named rows of the port's cache
            rows = np.array(rows, np.int32)
            jstate = {n: t[rows] for n, t in jstate.items()}
            tkw["rows"] = torch.from_numpy(rows)
        targs = (tq, tstate, tpos, ttot, kb, vb, a)
        got = F.linear_attention_quant_prefill_plain(*targs, **tkw)
        whole = F.linear_attention_quant_plain(*targs, **tkw)
    ref = np.asarray(jflash(jnp.asarray(q), jstate, jnp.asarray(qpos), jnp.asarray(total),
                            block_tables=jbt, k_bits=kb, v_bits=vb, compand_a=a,
                            sinks=None if sinks is None else jnp.asarray(sinks), interpret=True,
                            **kw))
    got = got.numpy()
    seen = F.has_valid_key(tpos, ttot, kw["sliding_window"]).numpy()
    assert seen.any()
    assert seen.all() == (case not in EMPTY_ROW_CASES)
    # f32 on both sides. The plain version rounds q, P and the dequantized
    # K/V values to hi + lo bf16 pairs (about 2^-16 of each value; a value on
    # the midpoint grid is held exactly, the lo.lo term left out), rotates q
    # and the output, and sums in another order
    tol = 1e-4 * np.abs(ref[seen]).max()
    np.testing.assert_allclose(got[seen], ref[seen], rtol=0, atol=tol)
    assert np.all(got[~seen] == 0.0)
    np.testing.assert_allclose(got, whole.numpy(), rtol=0, atol=tol)


def test_quant_prefill_plain_splits_kv_into_pairs():
    """The plain version takes f32 K/V as hi + lo bf16 pairs and bf16 K/V as
    they are: on values a bf16 holds exactly the two agree bit for bit, and
    on f32 values the pairs' sum sits far closer to the f32 product than bf16
    K/V alone."""
    rng = np.random.default_rng(17)
    B, S, Hq, Hk, D, T = 1, 40, 8, 2, 64, 150
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, Hk, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, Hk, D)).astype(np.float32))
    vis = F._causal_visible(torch.arange(100, 100 + S)[None].int(), torch.tensor([140]), T, "cpu")
    exact = F.attention_prefill_plain(q, k.bfloat16().float(), v.bfloat16().float(), vis, 0.125)
    bf16 = F.attention_prefill_plain(q, k.bfloat16(), v.bfloat16(), vis, 0.125)
    assert torch.equal(exact, bf16)
    # the attention of the f32 K/V the pairs stand for, in float64
    G = Hq // Hk
    kd, vd = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    sc = torch.einsum("bshd,bthd->bhst", q.double(), kd) * 0.125
    p = sc.masked_fill(~vis[:, None], -torch.inf).softmax(dim=-1)
    ref = torch.einsum("bhst,bthd->bshd", p, vd).float()
    pairs = F.attention_prefill_plain(q, k, v, vis, 0.125)
    assert (pairs - ref).abs().max() < 0.05 * (bf16 - ref).abs().max()
