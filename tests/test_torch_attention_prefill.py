"""The prefill body (csrc/attention_prefill.cuh) over the bf16 cache on the
CPU: its plain arithmetic, attention_prefill_plain (q blocks of PREFILL_ROWS
rows, 64-key tiles in the kernel's order, q and P as hi + lo bf16 pairs, the
online softmax in f32), through paged_attention_prefill_plain and
linear_attention_prefill_plain, against the JAX package's flash_attention in
interpret mode over the same numpy inputs: the paged and the linear layout,
D = 64 and 128, GQA groups 1, 2, 5, 7 and 8, a chunk that starts mid-page,
three sequences of unequal length, window + softcap + sinks with padded
rows, a sequence that sees no key, named linear rows with T no multiple of
64. Also the route each bf16 and quantized entry takes at S * G = 32 and 33
rows a kv head (decode kernel, prefill body), on the wrappers' side and in
the C entries' dispatch, and the header's widths. The quantized storage's
cases are tests/test_torch_attention_prefill_quant.py. The CUDA body is held
against the plain versions on the card by chip_smoke.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import flash_attention as F
from exllamav3_tpu_torch.ops import kv_quant as pq

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"


def _bf16_kv(rng, lead: tuple, Hk: int, D: int) -> tuple:
    """(JAX layer state, the port's) of random bf16 keys and values, the same
    bits on both sides."""
    jstate, tstate = {}, {}
    for name in ("k", "v"):
        x = jnp.asarray(rng.standard_normal((*lead, Hk, D)).astype(np.float32), jnp.bfloat16)
        jstate[name] = x
        tstate[name] = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
    return jstate, tstate


def _chunk(starts, S: int, pad: int = 0) -> np.ndarray:
    """(B, S) q positions: S consecutive positions from each start, the last
    `pad` of each row a padded slot at position 4096."""
    pos = np.array([np.arange(s, s + S) for s in starts], np.int32)
    if pad:
        pos[:, S - pad:] = 4096
    return pos


# (layout, D, (Hq, Hk), q positions, total lengths, block table or (rows, N, T),
#  features); every case has more than DECODE_ROWS rows a kv head
CASES = {
    # group 1 at 64-wide heads: 40 rows, the chunk starts mid-page (300 =
    # page 1 + 44) and ends in the page after
    "paged-d64-group1-mid-page": (
        "paged", 64, (4, 4), _chunk([300], 40), [340], [[3, 0, 2]], {}),
    # three sequences of unequal length (124, 424 and 674 keys), group 2, the
    # chunks starting mid-page; two pages of the widest table past the
    # shortest sequence
    "paged-d128-group2-three-sequences": (
        "paged", 128, (8, 4), _chunk([100, 400, 650], 24), [124, 424, 674],
        [[5, 1, 7], [2, 6, 0], [4, 8, 3]], {}),
    # group 5, a window of 100, a softcap of 20 and sinks; the last 4 rows
    # are padded slots past the sequence
    "paged-d64-group5-window-softcap-sinks-padded": (
        "paged", 64, (10, 2), _chunk([500], 20, pad=4), [516], [[2, 0, 1]],
        {"sliding_window": 100, "logit_softcap": 20.0, "sinks": True}),
    # group 7; sequence 1 has no key at all (total length 0)
    "paged-d128-group7-sequence-without-keys": (
        "paged", 128, (14, 2), _chunk([250, 0], 10), [260, 0], [[1, 2], [3, 0]], {}),
    # group 8, a prompt from position 0: 512 rows, four q blocks
    "paged-d64-group8-prompt": (
        "paged", 64, (16, 2), _chunk([0], 64), [64], [[1, 0]], {}),
    # named rows of a 5-row cache of T = 200 slots (no multiple of 64: the
    # last tile is cut), group 8, with sinks
    "linear-d128-group8-named-rows-T200": (
        "linear", 128, (16, 2), _chunk([150, 30], 20), [170, 50], ([3, 1], 5, 200),
        {"sinks": True}),
    # group 1 over T = 136 with a window of 50 and a softcap
    "linear-d64-group1-window-softcap-T136": (
        "linear", 64, (2, 2), _chunk([96], 40), [136], (None, 1, 136),
        {"sliding_window": 50, "logit_softcap": 30.0}),
    # group 5, two sequences of unequal length, the last 6 slots of each
    # chunk padded (a padded slot sees its sequence's keys). JAX's kernel
    # bounds the keys by total_lens only to its tile (the largest of 256..8
    # that divides T: 8 here), masking by position alone inside it, so a
    # padded slot past total_lens also sees the keys to the end of that tile
    # (50..55 of the shorter sequence); the port masks each key, as JAX's
    # dense path (linear_attention_plain) does. Padded slots are held to the
    # dense version only
    "linear-d64-group5-padded-T264": (
        "linear", 64, (10, 2), _chunk([200, 40], 16, pad=6), [216, 50], (None, 2, 264), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_plain_matches_jax_kernel(case):
    layout, D, (Hq, Hk), qpos, total, where, feats = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    total = np.array(total, np.int32)
    B, S = qpos.shape
    assert S * (Hq // Hk) > F.DECODE_ROWS
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    sinks = rng.standard_normal(Hq).astype(np.float32) if feats.get("sinks") else None
    kw = dict(scale=D ** -0.5, sliding_window=feats.get("sliding_window", 0),
              logit_softcap=feats.get("logit_softcap", 0.0))
    tkw = dict(kw, sinks=None if sinks is None else torch.from_numpy(sinks))
    tq, tpos, ttot = torch.from_numpy(q), torch.from_numpy(qpos), torch.from_numpy(total)
    if layout == "paged":
        bt = np.array(where, np.int32)
        jstate, tstate = _bf16_kv(rng, (int(bt.max()) + 1, PAGE_SIZE), Hk, D)
        jbt = jnp.asarray(bt)
        got = F.paged_attention_prefill_plain(tq, tstate["k"], tstate["v"], torch.from_numpy(bt),
                                              tpos, ttot, **tkw)
        whole = F.paged_attention_plain(tq, tstate["k"], tstate["v"], torch.from_numpy(bt), tpos,
                                        ttot, **tkw)
    else:
        rows, N, T = where
        jstate, tstate = _bf16_kv(rng, (N, T), Hk, D)
        jbt = None
        if rows is not None:  # JAX reads the named rows of the port's cache
            rows = np.array(rows, np.int32)
            jstate = {n: t[rows] for n, t in jstate.items()}
            tkw["rows"] = torch.from_numpy(rows)
        got = F.linear_attention_prefill_plain(tq, tstate["k"], tstate["v"], tpos, ttot, **tkw)
        whole = F.linear_attention_plain(tq, tstate["k"], tstate["v"], tpos, ttot, **tkw)
    ref = np.asarray(jflash(jnp.asarray(q), jstate, jnp.asarray(qpos), jnp.asarray(total),
                            block_tables=jbt, sinks=None if sinks is None else jnp.asarray(sinks),
                            interpret=True, **kw))
    got = got.numpy()
    seen = F.has_valid_key(tpos, ttot, kw["sliding_window"]).numpy()
    assert seen.any()
    # a padded slot past its sequence sees the sequence's keys, unless a
    # window puts them out of its reach
    assert seen.all() == (case not in ("paged-d128-group7-sequence-without-keys",
                                       "paged-d64-group5-window-softcap-sinks-padded"))
    # f32 on both sides; the plain version rounds q and P to hi + lo bf16
    # pairs (about 2^-16 of each value) and sums in another order
    tol = 1e-4 * np.abs(ref[seen]).max()
    held = seen & ((qpos < total[:, None]) if layout == "linear" else True)
    np.testing.assert_allclose(got[held], ref[held], rtol=0, atol=tol)
    assert np.all(got[~seen] == 0.0)
    np.testing.assert_allclose(got, whole.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "quant"])
@pytest.mark.parametrize("S,Hq,Hk", [(32, 8, 8), (33, 8, 8), (8, 32, 8), (11, 24, 8),
                                     (4, 64, 8), (3, 88, 8)])
def test_route_by_rows(S, Hq, Hk, quantized):
    """Up to DECODE_ROWS rows a kv head (S * G = 32 and below) every entry
    over the paged and the linear cache takes the decode kernel, with a
    workspace and the shared counters; one row more takes the prefill body
    over either storage, with no workspace, q rotated per 32-channel group
    for the quantized one."""
    rows = S * (Hq // Hk)
    assert rows in (32, 33)
    want = "decode" if rows <= 32 else "prefill"
    assert F.attention_route(S, Hq, Hk) == want
    q = torch.randn(1, S, Hq, 64)
    qk, ws, counters, split = F._decode_launch(q, Hk, 2 * PAGE_SIZE, 132, rotate=quantized)
    assert (ws is not None) == (want == "decode")
    assert (counters is not None) == (want == "decode") and (split > 0) == (want == "decode")
    if want == "prefill" and quantized:
        torch.testing.assert_close(qk, pq.rotate_groups(q), rtol=0, atol=0)
    else:
        assert qk is q


@pytest.mark.parametrize("source,bf16", [
    ("paged_attention.cu", True), ("linear_attention.cu", True),
    ("paged_attention_quant.cu", False), ("linear_attention_quant.cu", False)])
def test_entries_dispatch_on_rows(source, bf16):
    """The C entries choose as attention_route does: decode while S * G <=
    DECODE_ROWS, else the prefill body at both head widths, over the
    entry's storage (Bf16KV or QuantKV); none launches the tile loop."""
    src = (CSRC / source).read_text()
    assert "const bool decode = S * (Hq / Hk) <= DECODE_ROWS;" in src
    assert len(re.findall(r"launch_prefill<(?:64|128)>\(", src)) == 2
    assert "launch_attention<" not in src
    assert '#include "attention_prefill.cuh"' in src
    storage = "Bf16KV" if bf16 else "QuantKV"
    assert len(re.findall(rf"const {storage}<(?:64|128)> kv\{{", src)) == 2


def test_prefill_widths_match_the_kernel():
    """The plain version walks the kernel's blocks and tiles, read from the
    header, where each is defined once; a tile lies inside one page."""
    src = (CSRC / "attention_prefill.cuh").read_text()
    for name, value in (("PF_ROWS", F.PREFILL_ROWS), ("PF_TK", F.PREFILL_TILE)):
        assert re.findall(rf"^constexpr int {name} = (\d+);", src, re.M) == [str(value)]
    assert PAGE_SIZE % F.PREFILL_TILE == 0 and F.PREFILL_ROWS % 64 == 0
    assert re.search(r"static_assert\(BYTES <= PF_BLOCK_SHARED_MAX", src)
    assert "constexpr int PF_BLOCK_SHARED_MAX = 232448;" in src


def test_prefill_plain_rows_do_not_depend_on_their_block():
    """A row's result does not depend on the rows that share its block or on
    the tiles its block walks: the same rows as a group of 8 (16 tokens a
    block, each block walking its own keys) and as single heads (128 tokens a
    block) agree."""
    rng = np.random.default_rng(7)
    B, S, D, T = 1, 70, 64, 300
    q = torch.from_numpy(rng.standard_normal((B, S, 8, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, 1, D)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((B, T, 1, D)).astype(np.float32)).bfloat16()
    vis = F._causal_visible(torch.arange(100, 100 + S)[None].int(), torch.tensor([170]), T, "cpu",
                            sliding_window=40)
    grouped = F.attention_prefill_plain(q, k, v, vis, scale=0.125)
    heads = torch.cat([F.attention_prefill_plain(q[:, :, h:h + 1], k, v, vis, scale=0.125)
                       for h in range(8)], dim=2)
    # the products take other shapes, so the f32 sums may round apart
    torch.testing.assert_close(grouped, heads, rtol=0, atol=1e-6)
