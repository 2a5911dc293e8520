"""The split-key arithmetic of the decode kernel (csrc/attention_decode.cuh)
against the JAX package, on the CPU: the plain split versions (each split's
(acc, m, l) as attend_stats_plain computes them, joined by merge_stats)
against the JAX kernel in interpret mode, over the paged and the linear
layout, for the bf16 cache (k_bits = v_bits = 0) and the quantized one
(merged and per-head storage, bits (4, 4), (5, 3), (3, 7) and the
compander); splits of part of a page, of one page and of several, splits
wholly past total_lens or before a sliding window, sinks with a softcap,
rows that see no key, verify chunks, GQA groups 5 and 7 and named linear
cache rows. Also the split sizing function on host widths alone,
merge_stats without sinks and the wrappers' choice between the decode
kernel and the tile loop, for both storages. The CUDA kernel is held
against these plain versions on the card by chip_smoke.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops import kv_quant as jq
from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import build
from exllamav3_tpu_torch.ops import flash_attention as F
from exllamav3_tpu_torch.ops import kv_quant as pq

D = 64
SCALE = D ** -0.5
CSRC = Path(F.__file__).resolve().parent.parent / "csrc"


def _state(rng, lead: tuple, Hk: int, k_bits: int, v_bits: int, a: float) -> tuple:
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


def _bf16_state(rng, lead: tuple, Hk: int) -> tuple:
    """(JAX layer state, the port's) of random bf16 keys and values, the
    same bits on both sides."""
    jstate, tstate = {}, {}
    for name in ("k", "v"):
        x = jnp.asarray(rng.standard_normal((*lead, Hk, D)).astype(np.float32), jnp.bfloat16)
        jstate[name] = x
        tstate[name] = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
    return jstate, tstate


# (layout, (k_bits, v_bits), compand_a, (Hq, Hk), q positions, total lengths,
#  block table or cache rows T, features, split_keys); bits (0, 0): the bf16
#  cache. Feature "rows" names the linear cache row of each sequence
CASES = {
    # one page a split; the table is two pages wider than the longest
    # sequence, so sequence 0's last three splits and sequence 1's last two
    # lie wholly past total_lens
    "paged-4-4-page-splits-past-total": (
        "paged", (4, 4), 0.0, (8, 2), [[299], [700]], [300, 701],
        [[5, 1, 2, 7, 0], [3, 6, 4, 0, 2]], {}, 256),
    # splits of two pages over per-head storage, a verify chunk of 5
    "paged-5-3-verify-two-page-splits": (
        "paged", (5, 3), 0.0, (8, 2), [[600, 601, 602, 603, 604], [95, 96, 97, 98, 99]],
        [605, 100], [[2, 4, 1, 0], [3, 0, 5, 6]], {}, 512),
    # 64-key splits (a quarter page) with a window of 100: most splits lie
    # wholly before the window; sinks with a softcap of 20; row 1 is a padded
    # slot past its sequence, which sees no key
    "paged-3-7-compand-window-sinks-softcap": (
        "paged", (3, 7), 0.65, (8, 2), [[510], [4096]], [511, 300], [[1, 3], [2, 0]],
        {"sliding_window": 100, "logit_softcap": 20.0, "sinks": True}, 64),
    # the linear layout with the compander, group 5, 64-slot splits; sequence
    # 2 has no key at all (total length 0)
    "linear-4-4-compand-group5": (
        "linear", (4, 4), 0.65, (10, 2), [[199], [40], [0]], [200, 41, 0], 208, {}, 64),
    # group 7, a verify chunk, 128-slot splits, sinks and a softcap
    "linear-5-3-verify-group7-sinks-softcap": (
        "linear", (5, 3), 0.0, (14, 2), [[380, 381, 382, 383, 384], [60, 61, 62, 63, 64]],
        [385, 65], 400, {"logit_softcap": 20.0, "sinks": True}, 128),
    # the wrapper's own sizing (decode_split_keys) under a window of 100
    "linear-3-7-window-default-splits": (
        "linear", (3, 7), 0.0, (8, 2), [[330], [129]], [331, 130], 336,
        {"sliding_window": 100}, None),
    # the bf16 cache. One page a split; the table is two pages wider than the
    # longest sequence, so whole splits lie past total_lens
    "paged-bf16-page-splits-past-total": (
        "paged", (0, 0), 0.0, (8, 2), [[299], [700]], [300, 701],
        [[5, 1, 2, 7, 0], [3, 6, 4, 0, 2]], {}, 256),
    # a verify chunk of 5 at group 7 over splits of two pages
    "paged-bf16-verify-group7-two-page-splits": (
        "paged", (0, 0), 0.0, (14, 2), [[600, 601, 602, 603, 604], [95, 96, 97, 98, 99]],
        [605, 100], [[2, 4, 1, 0], [3, 0, 5, 6]], {}, 512),
    # quarter-page splits, a window of 100, sinks with a softcap of 20; row 1
    # is a padded slot past its sequence, which sees no key
    "paged-bf16-quarter-page-window-sinks-softcap": (
        "paged", (0, 0), 0.0, (8, 2), [[510], [4096]], [511, 300], [[1, 3], [2, 0]],
        {"sliding_window": 100, "logit_softcap": 20.0, "sinks": True}, 64),
    # group 5 over the linear layout; sequence 2 has no key (total length 0)
    "linear-bf16-group5-empty-sequence": (
        "linear", (0, 0), 0.0, (10, 2), [[199], [40], [0]], [200, 41, 0], 208, {}, 64),
    # named cache rows (sequence 0 in row 3, sequence 1 in row 1 of 5), a
    # verify chunk, 128-slot splits, sinks and a softcap
    "linear-bf16-named-rows-verify-sinks-softcap": (
        "linear", (0, 0), 0.0, (8, 2), [[380, 381, 382, 383, 384], [60, 61, 62, 63, 64]],
        [385, 65], 400, {"rows": [3, 1], "logit_softcap": 20.0, "sinks": True}, 128),
    # the wrapper's own sizing (decode_split_keys) under a window of 100
    "linear-bf16-window-default-splits": (
        "linear", (0, 0), 0.0, (8, 2), [[330], [129]], [331, 130], 336,
        {"sliding_window": 100}, None),
}


EMPTY_ROW_CASES = ("paged-3-7-compand-window-sinks-softcap", "linear-4-4-compand-group5",
                   "paged-bf16-quarter-page-window-sinks-softcap",
                   "linear-bf16-group5-empty-sequence")


@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_matches_jax_kernel(case):
    layout, (kb, vb), a, (Hq, Hk), qpos, total, where, feats, split = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    qpos, total = np.array(qpos, np.int32), np.array(total, np.int32)
    B, S = qpos.shape
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    sinks = rng.standard_normal(Hq).astype(np.float32) if feats.get("sinks") else None
    kw = dict(scale=SCALE, sliding_window=feats.get("sliding_window", 0),
              logit_softcap=feats.get("logit_softcap", 0.0))
    tkw = dict(kw, sinks=None if sinks is None else torch.from_numpy(sinks))
    make = (lambda lead: _bf16_state(rng, lead, Hk)) if kb == 0 else (
        lambda lead: _state(rng, lead, Hk, kb, vb, a))
    if layout == "paged":
        bt = np.array(where, np.int32)
        jstate, tstate = make((int(bt.max()) + 1, PAGE_SIZE))
        jbt, tbt = jnp.asarray(bt), (torch.from_numpy(bt),)
    elif "rows" in feats:  # JAX reads the named rows of the port's cache
        rows = np.array(feats["rows"], np.int32)
        jstate, tstate = make((int(rows.max()) + 2, where))
        jstate = {n: t[rows] for n, t in jstate.items()}
        jbt, tbt = None, ()
        tkw["rows"] = torch.from_numpy(rows)
    else:
        jstate, tstate = make((B, where))
        jbt, tbt = None, ()
    ref = np.asarray(jflash(jnp.asarray(q), jstate, jnp.asarray(qpos), jnp.asarray(total),
                            block_tables=jbt, k_bits=kb, v_bits=vb, compand_a=a,
                            sinks=None if sinks is None else jnp.asarray(sinks), interpret=True,
                            **kw))
    if kb == 0:
        targs = (torch.from_numpy(q), tstate["k"], tstate["v"], *tbt, torch.from_numpy(qpos),
                 torch.from_numpy(total))
        split_fn, whole_fn = ((F.paged_attention_split_plain, F.paged_attention_plain)
                              if layout == "paged" else
                              (F.linear_attention_split_plain, F.linear_attention_plain))
    else:
        targs = (torch.from_numpy(q), tstate, *tbt, torch.from_numpy(qpos),
                 torch.from_numpy(total), kb, vb, a)
        split_fn, whole_fn = ((F.paged_attention_quant_split_plain, F.paged_attention_quant_plain)
                              if layout == "paged" else
                              (F.linear_attention_quant_split_plain,
                               F.linear_attention_quant_plain))
    got = split_fn(*targs, split_keys=split, **tkw).numpy()
    seen = F.has_valid_key(torch.from_numpy(qpos), torch.from_numpy(total),
                           kw["sliding_window"]).numpy()
    assert seen.all() == (case not in EMPTY_ROW_CASES)
    # f32 on both sides; the rotations and sums are taken in another order
    tol = 1e-4 * np.abs(ref[seen]).max()
    np.testing.assert_allclose(got[seen], ref[seen], rtol=0, atol=tol)
    assert np.all(got[~seen] == 0.0)
    np.testing.assert_allclose(got, whole_fn(*targs, **tkw).numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("width,B,Hk,sms,want", [
    (2304, 8, 8, 132, 256),     # the 8B decode over a paged cache: 9 pages a table, one a split
    (2056, 8, 8, 132, 128),     # the same over a linear cache of T = 2056: 17 splits
    (2056, 1, 8, 132, 64),      # batch 1: one tile a split, 33 splits
    (8448, 8, 8, 132, 512),     # a table of 33 pages (one sequence at 8192): two pages a split
    (8200, 1, 8, 132, 256),     # batch 1 at 8192: no more than 64 splits
    (256 * 513, 1, 1, 132, 4096),  # 128K keys: 33 splits of 16 pages
    (40, 4, 2, 132, 64),        # shorter than a tile: one split
    (2056, 8, 8, 114, 256),     # a card of 114 SMs wants fewer blocks: 9 splits
    (2304, 8, 8, 264, 128),     # twice the SMs: half a page a split
])
def test_decode_split_keys(width, B, Hk, sms, want):
    """Host widths and the SM count alone fix the split: a power of two from
    one tile that divides a page or holds whole pages, at most
    DECODE_MAX_SPLITS splits, and enough blocks for the card unless a split
    is one tile already."""
    split = F.decode_split_keys(width, B, Hk, sms)
    assert split == want
    splits = -(-width // split)
    assert split & (split - 1) == 0 and split >= F.DECODE_TILE
    assert PAGE_SIZE % split == 0 or split % PAGE_SIZE == 0
    assert splits <= F.DECODE_MAX_SPLITS
    if split > F.DECODE_TILE:  # half the split would have given too many splits
        assert -(-width // (split // 2)) > min(
            F.DECODE_MAX_SPLITS, -(-F.DECODE_BLOCKS_PER_SM * sms // (B * Hk)))


def test_decode_constants_match_the_kernel(tmp_path, monkeypatch):
    """The wrapper's limits are read from the kernel's header, where each is
    defined once; a name defined twice or not at all raises."""
    src = (CSRC / "attention_decode.cuh").read_text()
    for name, value in (("DECODE_ROWS", F.DECODE_ROWS), ("DEC_TK", F.DECODE_TILE),
                        ("DEC_MAX_SPLITS", F.DECODE_MAX_SPLITS)):
        assert re.findall(rf"^constexpr int {name} = (\d+);", src, re.M) == [str(value)]
    assert PAGE_SIZE % F.DECODE_TILE == 0
    (tmp_path / "h.cuh").write_text("constexpr int A = 3;\nconstexpr int B = 1;\n"
                                    "constexpr int B = 2;\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.header_constants("h.cuh", "A") == (3,)
    for name in ("B", "C"):
        with pytest.raises(RuntimeError, match=name):
            build.header_constants("h.cuh", name)


_ROWS = [(1, 32, 8, True), (5, 32, 8, True), (4, 64, 8, True), (5, 56, 8, False),
         (2048, 32, 8, False)]


@pytest.mark.parametrize("S,Hq,Hk,decode,rotate", [
    *(pytest.param(*r, True, id="-".join(map(str, r))) for r in _ROWS),  # quantized
    *(pytest.param(*r, False, id="bf16-" + "-".join(map(str, r))) for r in _ROWS)])
def test_quant_launch_picks_the_kernel_by_rows(S, Hq, Hk, decode, rotate):
    """For both storages, S * G <= DECODE_ROWS takes the decode kernel: q as
    it is, a workspace of (acc, m, l) for every split, the shared zeroed
    counters. A taller chunk takes the tile loop with no workspace: q
    rotated for the quantized storage, as it is for bf16."""
    q = torch.randn(2, S, Hq, D)
    qk, ws, counters, split = F._decode_launch(q, Hk, 3 * PAGE_SIZE, 132, rotate=rotate)
    if decode:
        splits = -(-3 * PAGE_SIZE // split)
        assert qk is q and split == F.decode_split_keys(3 * PAGE_SIZE, 2, Hk, 132)
        assert ws.numel() == 2 * Hk * splits * S * (Hq // Hk) * (D + 2)
        assert counters.dtype == torch.int32 and counters.numel() >= 2 * Hk
        assert not counters.any()
    else:
        assert ws is None and counters is None
        if rotate:
            torch.testing.assert_close(qk, pq.rotate_groups(q), rtol=0, atol=0)
        else:
            assert qk is q


@pytest.mark.parametrize("empty", [True, False])
def test_merge_stats_without_sinks(empty):
    """merge_stats(parts, None): all-empty parts give 0; otherwise the merge
    is the one softmax over the parts' keys."""
    rng = np.random.default_rng(11)
    B, S, Hq, Hk, T = 2, 3, 4, 2, 50
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, Hk, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, Hk, D)).astype(np.float32))
    vis = torch.from_numpy(rng.random((B, S, T)) < 0.5)
    if empty:
        vis[:] = False
    parts = [F.attend_stats_plain(q, k[:, a:a + 20], vis[..., a:a + 20], SCALE,
                                  v=v[:, a:a + 20]) for a in range(0, T, 20)]
    got = F.merge_stats(parts)
    if empty:
        assert torch.equal(got, torch.zeros_like(got))
        return
    acc, m, l = F.attend_stats_plain(q, k, vis, SCALE, v=v)
    ref = acc / l[..., None]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))
