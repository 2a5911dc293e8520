"""The ring decode kernel's split arithmetic (csrc/attention_decode.cuh over
RingRows, launched by csrc/ring_attention.cu) against the JAX package, on
the CPU: `ring_attention_split_plain` (each split of a ring row's W slots
gives (acc, m, l) as attend_stats_plain computes them, ring_visible the
mask, merge_stats joins every split with the sinks) against JAX's ring
kernel in interpret mode (flash_ring_attention) and against its dense ring
path, at every split size from one 64-slot tile to the whole ring, with W
not a multiple of the split, never-written and stale slots, rings still
filling and rings that wrapped, GQA groups 1, 2, 5 and 7, heads of 64 and
128, sinks with a softcap of 50 and a sequence whose ring row holds no
visible slot (its output is 0). The CUDA kernel is held against these plain
versions on the card by chip_smoke.py."""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.attention import attend_dense as jattend_dense
from exllamav3_tpu.ops.flash_attention import flash_ring_attention
from exllamav3_tpu_torch.ops import flash_attention as F

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"

# name: (B, N, Hq, Hk, D, window, kind of each sequence's ring, sinks, softcap);
# a ring is "wrapped" (its query position past W), "filling" (below W) or
# "empty" (its row holds only slots never written and one stale future write)
CASES = {
    "group2-d128-wrapped": (3, 5, 4, 2, 128, 100, ("wrapped",) * 3, False, 0.0),
    "group1-d64-filling": (2, 4, 2, 2, 64, 183, ("filling", "filling"), False, 0.0),
    "group5-d64-sinks-softcap50": (3, 4, 10, 2, 64, 100, ("wrapped", "filling", "wrapped"),
                                   True, 50.0),
    "group7-d128-mixed-empty": (3, 5, 14, 2, 128, 183, ("filling", "empty", "wrapped"), False,
                                0.0),
}
SPLITS = (64, 128, 256)  # one tile up to past the largest W (200)


def _ring_w(window: int) -> int:
    """The port's ring width: window + 17 rounded up to 8 (modules/attn.py)."""
    w = window + 17
    return w + (-w) % 8


@functools.lru_cache(maxsize=None)
def _inputs(name: str):
    B, N, Hq, Hk, D, window, kinds, sinks, softcap = CASES[name]
    W = _ring_w(window)
    rng = np.random.default_rng(sorted(CASES).index(name) + 40)
    k = rng.standard_normal((N, W, Hk, D)).astype(np.float32)
    v = rng.standard_normal((N, W, Hk, D)).astype(np.float32)
    pos = np.full((N, W), -1, np.int32)
    slots = rng.permutation(N)[:B].astype(np.int32)
    qpos = np.zeros((B, 1), np.int32)
    for b, (row, kind) in enumerate(zip(slots, kinds)):
        if kind == "empty":  # nothing written but one stale speculative write
            p = int(rng.integers(5, W - 5))
            pos[row, (p + 2) % W] = p + 2
        else:
            p = int(rng.integers(W + 3, 4 * W) if kind == "wrapped" else rng.integers(3, W - 5))
            for t in range(max(0, p - W + 1), p + 1):
                pos[row, t % W] = t
            for t in range(p + 1, p + 1 + int(rng.integers(1, 4))):  # stale drafts
                pos[row, t % W] = t
        qpos[b, 0] = p
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    s = rng.standard_normal(Hq).astype(np.float32) if sinks else None
    kw = dict(scale=D ** -0.5, sliding_window=window, logit_softcap=softcap)
    return q, k, v, pos, slots, qpos, s, kw


@functools.lru_cache(maxsize=None)
def _jax_refs(name: str) -> tuple:
    """(JAX's ring kernel in interpret mode, JAX's dense ring path)."""
    q, k, v, pos, slots, qpos, sinks, kw = _inputs(name)
    js = None if sinks is None else jnp.asarray(sinks)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    kern = np.asarray(flash_ring_attention(jnp.asarray(q), kb, vb, jnp.asarray(pos),
                                           jnp.asarray(slots), jnp.asarray(qpos), sinks=js,
                                           interpret=True, **kw))
    kp = jnp.asarray(pos)[slots]
    dense = np.asarray(jattend_dense(jnp.asarray(q), kb[slots], vb[slots], jnp.asarray(qpos), kp,
                                     kp >= 0, sinks=js, **kw))
    return kern, dense


def _split_plain(name: str, split_keys):
    q, k, v, pos, slots, qpos, sinks, kw = _inputs(name)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return F.ring_attention_split_plain(
        torch.from_numpy(q), bf(k), bf(v), torch.from_numpy(pos), torch.from_numpy(slots),
        torch.from_numpy(qpos), sinks=None if sinks is None else torch.from_numpy(sinks),
        split_keys=split_keys, **kw).numpy()


@pytest.mark.parametrize("split", (*SPLITS, None), ids=[*map(str, SPLITS), "default"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_split_plain_matches_jax(name, split):
    """Every split size (None: decode_split_keys's own over W at 132 SMs)
    against JAX's ring kernel in interpret mode and its dense ring path, at
    2e-4 of the largest output: f32 on all sides, the splits' sums merged
    in another order. A sequence whose row holds no visible slot gives 0, as
    the port's ring kernel and its plain version do (JAX's two paths give
    that row an average over its masked slots instead: it is left out of the
    comparison)."""
    kern, dense = _jax_refs(name)
    got = _split_plain(name, split)
    seen = np.array([kind != "empty" for kind in CASES[name][6]])
    tol = 2e-4 * np.abs(kern[seen]).max()
    np.testing.assert_allclose(got[seen], kern[seen], rtol=0, atol=tol)
    np.testing.assert_allclose(got[seen], dense[seen], rtol=0, atol=tol)
    assert np.all(got[~seen] == 0.0) and np.all(got[seen] != 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_split_plain_matches_the_whole_ring(name):
    """The split arithmetic against the port's own one-softmax version
    (ring_attention_plain, which the CPU path serves) at every split size."""
    q, k, v, pos, slots, qpos, sinks, kw = _inputs(name)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    whole = F.ring_attention_plain(
        torch.from_numpy(q), bf(k), bf(v), torch.from_numpy(pos), torch.from_numpy(slots),
        torch.from_numpy(qpos), sinks=None if sinks is None else torch.from_numpy(sinks),
        **kw).numpy()
    for split in SPLITS:
        np.testing.assert_allclose(_split_plain(name, split), whole, rtol=0,
                                   atol=1e-5 * np.abs(whole).max())


def test_ring_split_plain_row_out_of_range_is_zero():
    """A sequence whose ring row lies outside the state sees no slot, as in
    the kernel; the other sequences are untouched."""
    q, k, v, pos, slots, qpos, sinks, kw = _inputs("group2-d128-wrapped")
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    args = (torch.from_numpy(q), bf(k), bf(v), torch.from_numpy(pos))
    out_slots = slots.copy()
    out_slots[1] = pos.shape[0]
    got = F.ring_attention_split_plain(*args, torch.from_numpy(out_slots),
                                       torch.from_numpy(qpos), split_keys=64, **kw)
    ref = F.ring_attention_split_plain(*args, torch.from_numpy(slots), torch.from_numpy(qpos),
                                       split_keys=64, **kw)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.equal(got[[0, 2]], ref[[0, 2]])


@pytest.mark.parametrize("W,B,Hk,want", [
    (1048, 8, 16, 128),   # Gemma-3-27B decode at batch 8: 9 splits of 128 slots
    (1048, 1, 16, 64),    # batch 1: one tile a split, 17 splits
    (4120, 8, 8, 256),    # Gemma-2-9B's window of 4096: 17 splits of 256
    (48, 8, 16, 64),      # a ring shorter than a tile: one split
])
def test_ring_split_keys(W, B, Hk, want):
    """The ring is sized as the other layouts are, over its W slots, and
    each split stays within the kernel's RING_TILES tiles."""
    split = F.decode_split_keys(W, B, Hk, 132)
    assert split == want
    assert -(-W // split) <= F.DECODE_MAX_SPLITS and split // F.DECODE_TILE <= F.RING_TILES
    assert F.RING_MAX_SLOTS == F.DECODE_MAX_SPLITS * F.RING_TILES * F.DECODE_TILE


def test_ring_constants_match_the_kernel():
    """The ring's limit is read from the decode kernel's header, where it is
    defined once, and the ring entry launches that kernel for groups of up
    to DECODE_ROWS heads."""
    src = (CSRC / "attention_decode.cuh").read_text()
    assert re.findall(r"^constexpr int DEC_RING_TILES = (\d+);", src, re.M) == [
        str(F.RING_TILES)]
    entry = (CSRC / "ring_attention.cu").read_text()
    assert "Hq / Hk <= DECODE_ROWS" in entry and "launch_decode_bf16" in entry
