"""The latent (MLA) decode kernel's arithmetic (csrc/latent_decode.cuh, kernel
row 6a at S = 1) against the JAX package on the CPU:
latent_attention_split_plain, the kernel's split of each sequence's keys with
each split's (acc, m, l) merged in split order, against JAX's
flash_attention(latent=512) in interpret mode, paged and linear, over a bf16
latent cache and 3- and 4-bit ones with and without the compander, at several
split sizes, with a sequence that sees no key and splits that see none; and
the split sizing over the layout at batch 1 to 8 and 16 or 128 heads. The
CUDA kernel is held against the plain versions on the card by chip_smoke.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu.ops.kv_quant import quantize_kv as jquantize
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import flash_attention as fa
from exllamav3_tpu_torch.util.params import _np_to_torch

C, DR, HQ = 512, 64, 16  # the kernel's latent and rope widths, DeepSeek-V2-Lite's heads
D = C + DR
TOTAL = np.array([300, 0, 520], np.int32)  # sequence 1 sees no key
# (layout, latent bits, compander)
CASES = [("paged", 0, 0.0), ("paged", 4, 0.0), ("paged", 3, 0.0), ("paged", 4, 0.65),
         ("linear", 0, 0.0), ("linear", 4, 0.0), ("linear", 3, 0.65)]


@functools.lru_cache(maxsize=None)
def _case(layout: str, bits: int, compand: float):
    """(q, cache state, q_positions, total_lens, where, JAX's output) for a
    decode step of 3 sequences: JAX's flash_attention(latent=512) in
    interpret mode on the same bf16 q and cache state (its quantized words
    and scales carried across). The paged block table is 3 pages wide and
    the linear cache 640 slots, so splits past each sequence's keys see
    none."""
    rng = np.random.default_rng(30 + bits)
    B = len(TOTAL)
    q = jnp.asarray(rng.standard_normal((B, 1, HQ, D)).astype(np.float32) * 0.2, jnp.bfloat16)
    qpos = TOTAL[:, None] - 1
    if layout == "paged":
        raw = rng.standard_normal((8, PAGE_SIZE, 1, D)).astype(np.float32) * 0.3
        bt = np.array([[3, 5, 0], [1, 2, 4], [6, 7, 2]], np.int32)
        where = dict(block_tables=bt)
    else:
        raw = rng.standard_normal((B, 640, 1, D)).astype(np.float32) * 0.3
        where = {}
    if bits:
        lat_q, lat_s = jquantize(jnp.asarray(raw[..., :C]), bits, compand)
        state = {"kv_q": lat_q, "kv_s": lat_s, "k_pe": jnp.asarray(raw[..., C:], jnp.bfloat16)}
    else:
        state = {"kv": jnp.asarray(raw, jnp.bfloat16)}
    ref = np.asarray(jflash(q, state, jnp.asarray(qpos), jnp.asarray(TOTAL), scale=D ** -0.5,
                            latent=C, k_bits=bits, compand_a=compand, interpret=True,
                            **{n: jnp.asarray(v) for n, v in where.items()}))
    pstate = {n: _np_to_torch(np.asarray(t)) for n, t in state.items()}
    pwhere = {n: torch.from_numpy(v) for n, v in where.items()}
    return _np_to_torch(np.asarray(q)), pstate, torch.from_numpy(qpos), torch.from_numpy(TOTAL), \
        pwhere, ref


@pytest.mark.parametrize("layout,bits,compand", CASES,
                         ids=[f"{l}-{b}bit-a{a}" for l, b, a in CASES])
def test_split_plain_matches_jax_kernel(layout, bits, compand):
    """latent_attention_split_plain at split sizes 64 (a split of keys
    256-319 of sequence 0 sees none, and so do its last six), 128, 256 and
    the sizing's own, against JAX's kernel in interpret mode at 2e-3 (the
    JAX test's own tolerance, tests/test_torch_mla.py); the sequence that
    sees no key gives 0, as the kernel's empty records merge to."""
    q, state, qp, tl, where, ref = _case(layout, bits, compand)
    width = 3 * PAGE_SIZE if layout == "paged" else 640
    seen = np.ones(len(TOTAL), bool)
    seen[1] = False
    for split in (64, 128, 256, None):
        got = fa.latent_attention_split_plain(q, state, qp, tl, C, bits, compand, scale=D ** -0.5,
                                              split_keys=split, **where)
        assert got.shape == (len(TOTAL), 1, HQ, C)
        assert torch.isfinite(got).all() and got[1].abs().max() == 0
        np.testing.assert_allclose(got.numpy()[seen], ref[seen], rtol=2e-3, atol=2e-3)
    assert fa.latent_split_keys(width, len(TOTAL), HQ) in (64, 128, 256)
    # the plain version the dispatcher runs on the CPU agrees with the split arithmetic
    plain = fa.latent_attention_any(q, state, qp, tl, C, k_bits=bits, compand_a=compand,
                                    scale=D ** -0.5, **where)
    split = fa.latent_attention_split_plain(q, state, qp, tl, C, bits, compand, scale=D ** -0.5,
                                            **where)
    np.testing.assert_allclose(split.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)


def test_split_plain_holds_pages_out_of_range_to_no_key():
    """A page out of range in a block table (-1, or past the cache) holds no
    visible key: its split sees none while the splits after it do, as the
    kernel skips such a tile. Against the same attention over the sequence
    with those keys' pages swapped for a page of zero keys, masked out."""
    q, state, qp, tl, where, _ = _case("paged", 0, 0.0)
    bt = where["block_tables"].clone()
    bt[2, 1] = -1  # keys 256-511 of sequence 2 (of 520)
    bt[0, 2] = 99  # past the cache, beyond sequence 0's keys anyway
    got = fa.latent_attention_split_plain(q, state, qp, tl, C, scale=D ** -0.5, split_keys=64,
                                          block_tables=bt)
    k = state["kv"][bt.clamp(0, 7).long()].reshape(3, -1, D).float()
    vis = torch.arange(k.shape[1])[None, :] < tl[:, None]
    vis[2, 256:512] = False
    s = torch.einsum("bhd,btd->bht", q[:, 0].float(), k) * D ** -0.5
    s = torch.where(vis[:, None, :], s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    want = torch.einsum("bht,btd->bhd", p, k[..., :C])
    np.testing.assert_allclose(got[[0, 2], 0].numpy(), want[[0, 2]].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert got[1].abs().max() == 0


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("Hq", [16, 128])
def test_split_sizing_covers_the_layout(B, Hq):
    """latent_split_keys at every layout width the serve paths give (paged
    block tables of 1 to 64 pages, linear caches of any T): a multiple of
    LATENT_TILE dividing the page below it and holding whole pages above, at
    most LATENT_MAX_SPLITS splits covering every key, as many as the card's
    SMs at LATENT_BLOCKS_PER_SM blocks each allow; 132 and 114 SMs."""
    for sms in (132, 114):
        want = min(fa.LATENT_MAX_SPLITS,
                   max(1, -(-fa.LATENT_BLOCKS_PER_SM * sms // (B * -(-Hq // fa.LATENT_ROWS)))))
        for width in [PAGE_SIZE * p for p in range(1, 65)] + [1, 63, 300, 2052, 2056, 8193]:
            split = fa.latent_split_keys(width, B, Hq, sms)
            ns = -(-width // split)
            assert split % fa.LATENT_TILE == 0 and ns * split >= width
            assert (PAGE_SIZE % split == 0) if split < PAGE_SIZE else (split % PAGE_SIZE == 0)
            assert ns <= min(want, fa.LATENT_MAX_SPLITS)
            # the next smaller split would give too many
            assert split == fa.LATENT_TILE or -(-width // (split // 2)) > want
