"""The latent (MLA) prefill body (csrc/latent_prefill.cuh) on the CPU: its
plain arithmetic (latent_attention_prefill_plain over the bf16 latent,
latent_attention_quant_prefill_plain over the quantized one: attention_prefill_plain
at the body's geometry, 64 (token, head) rows a block and 32-key tiles, q
bf16 in one product, P as hi + lo bf16 pairs, the quantized latent's values
as exact hi + lo pairs and the rope key's lo 0, the lo.lo term left out)
against the JAX package's flash_attention with `latent` in interpret mode on
the same numpy inputs: paged and linear, bf16, (4) and (3) and the compander
at 0.65, 16 heads and a group of 80 (two head slices), a chunk that starts
mid-page, a verify-shaped chunk (S = 5), a sequence that sees no key, named
linear rows and a linear T that is no multiple of the tile. Then the plain
version against latent_attention_plain at DeepSeek's c = 512, and the
scratch the wrappers hand the kernels, in whole tiles. The CUDA kernels are
held against the plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu.ops.kv_quant import quantize_kv as jquantize
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import flash_attention as F
from exllamav3_tpu_torch.util.params import _np_to_torch

C, DR = 128, 64  # tests/test_torch_mla.py's latent and rope widths


def _chunk(starts, S: int) -> np.ndarray:
    """(B, S) q positions: S consecutive positions from each start."""
    return np.array([np.arange(s, s + S) for s in starts], np.int32)


# (layout, latent bits, compand_a, q heads, q positions, total lengths, block
#  table or (rows, N, T))
CASES = {
    # a prompt chunk that starts mid-page (500 = page 1 + 244) and ends in the
    # page after: 384 rows, 6 q blocks of 4 tokens x 16 heads
    "paged-bf16-h16-mid-page": ("paged", 0, 0.0, 16, _chunk([500], 24), [524], [[3, 1, 0]]),
    # a verify-shaped chunk (S = 5) of two sequences
    "paged-4-h16-verify": ("paged", 4, 0.0, 16, _chunk([296, 120], 5), [301, 125],
                           [[1, 2], [3, 0]]),
    # 80 heads: q blocks of one token's 64 heads and the 16 left, two slices
    "paged-3-h80-two-slices": ("paged", 3, 0.0, 80, _chunk([200], 3), [203], [[2, 1]]),
    # the compander; sequence 1 sees no key (total length 0)
    "paged-4-compand-h16-sequence-without-keys": (
        "paged", 4, 0.65, 16, _chunk([250, 0], 12), [262, 0], [[1, 2], [3, 0]]),
    # named rows of a 5-row cache of T = 200 slots (6 tiles and 8 keys)
    "linear-bf16-h16-named-rows-T200": ("linear", 0, 0.0, 16, _chunk([150, 30], 20), [170, 50],
                                        ([3, 1], 5, 200)),
    # row 0 of a cache of T = 136, the chunk running to its end
    "linear-3-compand-h16-T136": ("linear", 3, 0.65, 16, _chunk([116], 20), [136],
                                  (None, 1, 136)),
}


def _cache(rng, lead: tuple, bits: int, a: float) -> tuple:
    """(JAX layer state, the port's) of a random latent cache [c_kv | k_pe]:
    bf16 rows, or the latent quantized by the JAX package beside the bf16
    rope key."""
    raw = rng.standard_normal((*lead, 1, C + DR)).astype(np.float32) * 0.3
    if bits:
        lat_q, lat_s = jquantize(jnp.asarray(raw[..., :C]), bits, a)
        jstate = {"kv_q": lat_q, "kv_s": lat_s, "k_pe": jnp.asarray(raw[..., C:], jnp.bfloat16)}
    else:
        jstate = {"kv": jnp.asarray(raw, jnp.bfloat16)}
    return jstate, {n: _np_to_torch(np.asarray(t)) for n, t in jstate.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_latent_prefill_plain_matches_jax_kernel(case):
    """The body's plain arithmetic against JAX's MLA kernel in interpret mode,
    and against the dense plain version, within 1e-4 of the largest output;
    rows that see no key give 0."""
    layout, bits, a, Hq, qpos, total, where = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    total = np.array(total, np.int32)
    B, S = qpos.shape
    D = C + DR
    q = jnp.asarray(rng.standard_normal((B, S, Hq, D)).astype(np.float32) * 0.2, jnp.bfloat16)
    kw = dict(scale=D ** -0.5)
    if layout == "paged":
        bt = np.array(where, np.int32)
        jstate, tstate = _cache(rng, (int(bt.max()) + 1, PAGE_SIZE), bits, a)
        jwhere, twhere = dict(block_tables=jnp.asarray(bt)), dict(block_tables=torch.from_numpy(bt))
    else:
        rows, N, T = where
        jstate, tstate = _cache(rng, (N, T), bits, a)
        jwhere, twhere = {}, {}
        if rows is not None:  # JAX reads the named rows of the port's cache
            rows = np.array(rows, np.int32)
            jstate = {n: t[rows] for n, t in jstate.items()}
            twhere["rows"] = torch.from_numpy(rows)
    ref = np.asarray(jflash(q, jstate, jnp.asarray(qpos), jnp.asarray(total), latent=C,
                            k_bits=bits, compand_a=a, interpret=True, **jwhere, **kw))
    tq = _np_to_torch(np.asarray(q))
    targs = (tq, torch.from_numpy(qpos), torch.from_numpy(total))
    if bits:
        got = F.latent_attention_quant_prefill_plain(tq, tstate, *targs[1:], bits, a, **twhere,
                                                     **kw)
        dense = F.latent_attention_quant_plain(tq, tstate, *targs[1:], bits, a, **twhere, **kw)
    else:
        got = F.latent_attention_prefill_plain(tq, tstate["kv"], *targs[1:], C, **twhere, **kw)
        dense = F.latent_attention_plain(tq, tstate["kv"], *targs[1:], C, **twhere, **kw)
    assert got.shape == (B, S, Hq, C)
    got = got.numpy()
    seen = F.has_valid_key(*targs[1:]).numpy()
    assert seen.any()
    assert seen.all() == ("without-keys" not in case)
    # f32 on both sides: q is bf16 (exact), the quantized latent's values are
    # exact hi + lo pairs; P enters as a hi + lo pair (about 2^-16 of each
    # value, the lo.lo term left out), and the sums run in another order
    tol = 1e-4 * np.abs(ref[seen]).max()
    np.testing.assert_allclose(got[seen], ref[seen], rtol=0, atol=tol)
    assert np.all(got[~seen] == 0.0)
    np.testing.assert_allclose(got, dense.numpy(), rtol=0, atol=tol)
    # the dispatch's plain version for CPU tensors is the dense one
    again = F.latent_attention_any(tq, tstate, *targs[1:], C, k_bits=bits, compand_a=a,
                                   **twhere, **kw)
    assert torch.equal(again, dense)


def test_latent_prefill_plain_matches_dense_at_full_width():
    """At DeepSeek's c = 512 (16 heads, a page out of range in one table),
    the body's arithmetic against latent_attention_plain over the same bf16
    rows, within 1e-4 of the largest output; a page out of range holds no
    visible key."""
    rng = np.random.default_rng(31)
    B, S, Hq, D = 2, 33, 16, F.LATENT + F.ROPE
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32) * 0.2).bfloat16()
    kv = torch.from_numpy(rng.standard_normal((5, PAGE_SIZE, 1, D)).astype(np.float32)).bfloat16()
    qpos = torch.from_numpy(_chunk([400, 40], S))
    total = torch.tensor([433, 73], dtype=torch.int32)
    bt = torch.tensor([[4, 2], [1, 3]], dtype=torch.int32)
    got = F.latent_attention_prefill_plain(q, kv, qpos, total, F.LATENT, block_tables=bt,
                                           scale=0.07)
    ref = F.latent_attention_plain(q, kv, qpos, total, F.LATENT, block_tables=bt, scale=0.07)
    tol = 1e-4 * float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    # page 1 of sequence 0 out of range: its keys 256..511 are not seen
    gone = bt.clone()
    gone[0, 1] = 7
    cut = F.latent_attention_prefill_plain(q, kv, qpos, total, F.LATENT, block_tables=gone,
                                           scale=0.07)
    only = F.latent_attention_plain(q[:1], kv, qpos[:1], torch.tensor([256], dtype=torch.int32),
                                    F.LATENT, block_tables=bt[:1], scale=0.07)
    torch.testing.assert_close(cut[:1], only, rtol=0, atol=tol)
    torch.testing.assert_close(cut[1:], got[1:], rtol=0, atol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("width", [2052, 2816])
def test_latent_prefill_scratch_holds_whole_tiles(quant, width):
    """A chunk of more than one token hands the kernels a scratch of whole
    LATENT_PREFILL_TILE-key tiles of the layout's width (576 bf16 a key, 1088
    over the quantized latent), which the pre-pass fills and the body reads
    tile by tile; decode hands over the split workspace instead."""
    B = 3
    q = torch.zeros((B, 4, 16, F.LATENT + F.ROPE), dtype=torch.bfloat16)
    ws, counters, split_keys = F._latent_launch(q, width, F.H100_SMS, quant)
    tiles = -(-width // F.LATENT_PREFILL_TILE)
    per_key = 2 * F.LATENT + F.ROPE if quant else F.LATENT + F.ROPE
    assert ws.dtype == torch.bfloat16 and counters is None and split_keys == 0
    assert ws.numel() == B * tiles * F.LATENT_PREFILL_TILE * per_key
    assert (F.LATENT_PREFILL_ROWS, F.LATENT_PREFILL_TILE) == (64, 32)
