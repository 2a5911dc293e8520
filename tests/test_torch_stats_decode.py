"""The split-key stats kernel's arithmetic (csrc/latent_decode.cuh with the
STATS epilogue at 512 channels, kernel row 6b) against the JAX package on the
CPU: the three stats entries' plain versions with `split_keys`, each split's
(acc, m, l) merged in split order as the kernel merges them (merge_splits),
against the JAX kernel with return_stats in interpret mode, at DeepSeek-V4's
row width and 16 heads: the sliding ring (W = 144, window 128, stale and
never-written slots), the HCA pool (2-entry pages through a shuffled block
table) and the CSA rows gathered into a linear layout. Each layout has a
sequence that sees no key (exactly (0, -1e30, 0)) and a split that sees
none. Also the split sizing over every width the three layouts give, and the
constants the wrappers read against the kernel's header. The CUDA kernel is
held against the plain versions on the card by chip_smoke.py.

Tolerance 2e-3 as tests/test_torch_attention_stats.py: the JAX kernel masks
with a finite NEG_INF, so on a sequence that sees no key its acc and l count
exp(0) for every masked key; there m is held to JAX's and (acc, l) to 0."""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu.ops.flash_attention import flash_ring_attention as jring
from exllamav3_tpu_torch.ops import flash_attention as F

D, H = F.KV_ROW, 16
SCALE = D ** -0.5
TOL = 2e-3
CSRC = Path(F.__file__).resolve().parent.parent / "csrc"


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 values, kept f32."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _t(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def _check(port, jax_out, empty_rows):
    acc, m, l = (t.numpy() for t in port)
    jacc, jm, jl = (np.asarray(t) for t in jax_out)
    keep = np.ones(m.shape[0], bool)
    keep[list(empty_rows)] = False
    assert np.isfinite(acc).all() and np.isfinite(l).all()
    np.testing.assert_allclose(m, jm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(acc[keep], jacc[keep], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l[keep], jl[keep], rtol=TOL, atol=TOL)
    for b in empty_rows:
        assert (m[b] == F.NEG_INF).all() and (acc[b] == 0).all() and (l[b] == 0).all()


def _splits(width: int) -> list:
    """The split sizes tried: the unit (64), 128, and the sizing's own."""
    return sorted({F.LATENT_TILE, 2 * F.LATENT_TILE, F.latent_split_keys(width, 3, H)})


@functools.lru_cache(maxsize=None)
def _ring_case():
    """A decode step over DeepSeek-V4's ring (W = 144, window 128): sequence 0
    on a full ring with a stale speculative slot, sequence 1 on a ring of 10
    written slots (its splits past the first see none), sequence 2 on a ring
    whose slots all lie outside the window (it sees no key)."""
    rng = np.random.default_rng(40)
    N, W, B, window = 4, 144, 3, 128
    ring = _bf16(rng.standard_normal((N, W, D)) * 0.5)
    pos = np.full((N, W), -1, np.int32)
    pos[1] = np.arange(1000, 1000 + W) % W + 900        # positions 900..1043 in some slot order
    pos[1, 7] = 2000                                     # stale: a future position
    pos[3, :10] = np.arange(10)                          # 10 slots written
    pos[0, :W] = np.arange(W)                            # all more than a window behind
    slots = np.array([1, 3, 0], np.int32)
    qpos = np.array([[1043], [9], [400]], np.int32)
    q = _bf16(rng.standard_normal((B, 1, H, D)))
    want = jring(jnp.asarray(q), jnp.asarray(ring[:, :, None]), jnp.asarray(ring[:, :, None]),
                 jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(qpos), scale=SCALE,
                 sliding_window=window, return_stats=True, interpret=True)
    return q, ring, pos, slots, qpos, window, want


def test_ring_split_stats_match_jax():
    q, ring, pos, slots, qpos, window, want = _ring_case()
    args = (_t(q), _t(ring), _t(pos), _t(slots), _t(qpos))
    vis = F.ring_visible(_t(pos)[_t(slots).long()], _t(qpos), window)
    assert not vis[1, 0, 64:].any() and vis[1, 0, :10].all()  # splits past the first see none
    for split in _splits(pos.shape[1]):
        got = F.ring_attention_stats_plain(*args, scale=SCALE, sliding_window=window,
                                           split_keys=split)
        _check(got, want, empty_rows=[2])


@functools.lru_cache(maxsize=None)
def _pool_case():
    """The HCA pool: 2 entries a page through a shuffled block table of 48
    pages (96 entries: two 64-entry splits); sequence 0 sees 70 entries (both
    splits), 1 none, 2 30 (its second split sees none)."""
    rng = np.random.default_rng(41)
    P, epp, MP, B = 160, 2, 48, 3
    pool = _bf16(rng.standard_normal((P, epp, D)) * 0.5)
    bt = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    total = np.array([70, 0, 30], np.int32)
    qpos = (total - 1)[:, None].astype(np.int32)
    q = _bf16(rng.standard_normal((B, 1, H, D)))
    want = jflash(jnp.asarray(q), {"kv": jnp.asarray(pool[:, :, None])}, jnp.asarray(qpos),
                  jnp.asarray(total), block_tables=jnp.asarray(bt), scale=SCALE, latent=D,
                  return_stats=True, interpret=True)
    return q, pool, bt, qpos, total, want


def test_pool_split_stats_match_jax_over_shuffled_pages():
    q, pool, bt, qpos, total, want = _pool_case()
    for split in _splits(bt.shape[1] * pool.shape[1]):
        got = F.pool_attention_stats_plain(_t(q), _t(pool), _t(bt), _t(qpos), _t(total),
                                           scale=SCALE, split_keys=split)
        _check(got, want, empty_rows=[1])


def test_pool_split_stats_hide_pages_out_of_range():
    """A page out of range inside the visible entries (-1, or past the pool)
    hides its two entries, as the kernel's key table does: the split form
    equals the single shot over the same mask, and both equal the dense
    softmax over the entries left."""
    q, pool, bt, qpos, total, _ = _pool_case()
    bt = bt.copy()
    bt[0, 3], bt[0, 40], bt[2, 0] = -1, 10 ** 6, -5
    args = (_t(q), _t(pool), _t(bt), _t(qpos), _t(total))
    one = F.pool_attention_stats_plain(*args, scale=SCALE)
    for split in (64, 128):
        got = F.pool_attention_stats_plain(*args, scale=SCALE, split_keys=split)
        for a, b_ in zip(got, one):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-5, atol=1e-5)
    acc, m, l = one
    for b in (0, 2):
        keep = [e for e in range(total[b]) if 0 <= bt[b, e // 2] < pool.shape[0]]
        k = pool[bt[b, np.array(keep) // 2], np.array(keep) % 2]          # (n, D)
        s = q[b, 0] @ k.T * SCALE                                           # (H, n)
        np.testing.assert_allclose(m[b, 0].numpy(), s.max(-1), rtol=1e-5, atol=1e-5)
        p = np.exp(s - s.max(-1, keepdims=True))
        np.testing.assert_allclose(l[b, 0].numpy(), p.sum(-1), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(acc[b, 0].numpy(), p @ k, rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _rows_case():
    """The CSA selection gathered into rows of 160 (three splits of 64 at
    the unit): 150, 0 and 40 of them visible (fictional positions 0..K-1, the
    query at vcount - 1): sequence 2's last two splits see none."""
    rng = np.random.default_rng(42)
    B, T = 3, 160
    kv = _bf16(rng.standard_normal((B, T, D)) * 0.5)
    vcount = np.array([150, 0, 40], np.int32)
    qpos = (vcount - 1)[:, None].astype(np.int32)
    q = _bf16(rng.standard_normal((B, 1, H, D)))
    want = jflash(jnp.asarray(q), {"kv": jnp.asarray(kv[:, :, None])}, jnp.asarray(qpos),
                  jnp.asarray(vcount), scale=SCALE, latent=D, return_stats=True, interpret=True)
    return q, kv, qpos, vcount, want


def test_rows_split_stats_match_jax():
    q, kv, qpos, vcount, want = _rows_case()
    for split in _splits(kv.shape[1]):
        got = F.rows_attention_stats_plain(_t(q), _t(kv), _t(qpos), _t(vcount), scale=SCALE,
                                           split_keys=split)
        _check(got, want, empty_rows=[1])


def test_merge_splits_in_split_order():
    """merge_splits weighs each split by exp(m_s - max m) and drops a split
    whose m is -1e30; over splits that all saw none it gives (0, -1e30, 0),
    and one split is returned as it is."""
    rng = np.random.default_rng(43)
    acc = [torch.from_numpy(rng.standard_normal((2, 1, 3, 4)).astype(np.float32)) for _ in range(3)]
    m = [torch.tensor([[[0.5, F.NEG_INF, 1.0]], [[F.NEG_INF] * 3]], dtype=torch.float32),
         torch.tensor([[[2.0, F.NEG_INF, -1.0]], [[F.NEG_INF] * 3]], dtype=torch.float32),
         torch.tensor([[[F.NEG_INF, F.NEG_INF, 0.0]], [[F.NEG_INF] * 3]], dtype=torch.float32)]
    l = [torch.from_numpy(rng.random((2, 1, 3)).astype(np.float32) + 1) for _ in range(3)]
    for s in range(3):  # a split that saw no key holds no acc and no l
        acc[s][m[s] <= F.NEG_INF / 2] = 0.0
        l[s][m[s] <= F.NEG_INF / 2] = 0.0
    ga, gm, gl = F.merge_splits(list(zip(acc, m, l)))
    np.testing.assert_allclose(gm[0, 0].numpy(), [2.0, F.NEG_INF, 1.0])
    c = [np.exp(0.5 - 2.0), 1.0]
    np.testing.assert_allclose(ga[0, 0, 0].numpy(), c[0] * acc[0][0, 0, 0].numpy()
                               + c[1] * acc[1][0, 0, 0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(gl[0, 0, 0].item(), c[0] * l[0][0, 0, 0].item() + l[1][0, 0, 0].item(),
                               rtol=1e-6)
    assert (gm[1] == F.NEG_INF).all() and (ga[1] == 0).all() and (gl[1] == 0).all()
    assert (gm[0, 0, 1] == F.NEG_INF) and (ga[0, 0, 1] == 0).all() and gl[0, 0, 1] == 0
    one = F.merge_splits([(acc[0], m[0], l[0])])
    for x, y in zip(one, (acc[0], m[0], l[0])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("Hq", [16, 128])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32, 64, 128])
def test_split_sizing_covers_every_layout_width(B, Hq):
    """latent_split_keys at the widths the three layouts give: rings of W =
    window + 16 (DeepSeek-V4's 144, and windows up to 8192), HCA pools of 1
    to 32768 pages of 2 entries (4096 pages: the published 1M-token context;
    32768 the most LATENT_MAX_SPLITS splits of the table hold), and CSA rows
    of 1 to 2048: a multiple of LATENT_TILE, at most LATENT_MAX_SPLITS splits
    covering every key, and over the ring and the pool (table=True) at most
    LATENT_TABLE_KEYS keys a split, whatever the batch; 132 and 114 SMs. A
    pool wider than that is refused on the host. The wrappers' workspace
    holds every split's record."""
    rings = [w + 16 for w in (128, 256, 1024, 4096, 8192)]
    pools = [mp * 2 for mp in (1, 2, 9, 64, 512, 4096, 16384, 32768)]
    rows = [1, 63, 64, 65, 160, 512, 2048]
    for sms in (132, 114):
        for table, widths in ((True, rings + pools), (False, rows)):
            for width in widths:
                split = F.latent_split_keys(width, B, Hq, sms, table)
                ns = -(-width // split)
                assert split % F.LATENT_TILE == 0 and ns * split >= width
                assert ns <= F.LATENT_MAX_SPLITS
                assert not table or split <= F.LATENT_TABLE_KEYS
        with pytest.raises(ValueError):
            F.latent_split_keys(F.LATENT_MAX_SPLITS * F.LATENT_TABLE_KEYS + 1, B, Hq, sms, True)
    q = torch.zeros((B, 1, Hq, D), dtype=torch.bfloat16)
    for width, table in ((144, True), (8192, True), (512, False)):
        ws, counters, split = F._latent_launch(q, width, 132, False, table)
        slices = -(-Hq // F.LATENT_ROWS)
        assert counters.numel() >= B * slices and not counters.any()
        assert ws.numel() * ws.element_size() >= (
            4 * B * slices * -(-width // split) * F.LATENT_ROWS * (F.LATENT + 2))


def test_table_split_is_capped_where_the_grid_asks_for_more():
    """Over DeepSeek-V4's 1M-token HCA pool (8192 entries) at 128 heads, the
    grid alone asks for 4096-entry splits from B = 22 on 132 SMs; the table
    layouts take LATENT_TABLE_KEYS instead (4 splits), the rows keep the
    grid's split."""
    width, Hq = 8192, 128
    assert F.latent_split_keys(width, 21, Hq, 132) == F.LATENT_TABLE_KEYS
    for B in (22, 23, 66, 128):
        assert F.latent_split_keys(width, B, Hq, 132) > F.LATENT_TABLE_KEYS
        assert F.latent_split_keys(width, B, Hq, 132, True) == F.LATENT_TABLE_KEYS


def test_stats_constants_match_the_kernel():
    """The widths and limits the wrappers read are the header's, each defined
    once; the stats entries launch the latent decode kernel with the STATS
    epilogue over the ring, the pool and the rows, and the tile loop holds
    no stats path any more."""
    header = (CSRC / "latent_decode.cuh").read_text()
    for name, value in (("KV_ROW", F.KV_ROW), ("LAT_TABLE_KEYS", F.LATENT_TABLE_KEYS),
                        ("LAT_ROWS", F.LATENT_ROWS), ("LAT_TILE", F.LATENT_TILE),
                        ("LAT_MAX_SPLITS", F.LATENT_MAX_SPLITS)):
        assert re.findall(rf"^constexpr int {name} = (\d+);", header, re.M) == [str(value)]
    assert F.KV_ROW == F.LATENT == 512
    # a split's record: 16 rows of 512 then m and l of each
    assert re.search(r"LAT_REC = LAT_ROWS \* LATENT \+ 2 \* LAT_ROWS;", header)
    src = (CSRC / "attention_stats.cu").read_text()
    assert '#include "latent_decode.cuh"' in src and "attention_tiles.cuh" not in src
    assert sorted(re.findall(r"launch_latent_decode<(\w+), StatsRows, true>", src)) == [
        "LinearRows", "PoolRows", "RingRows"]
    tiles = (CSRC / "attention_tiles.cuh").read_text()
    assert "STATS" not in tiles and "KvRowDecodeGeo" not in tiles and "RowKV" not in tiles
    assert "load_gather" not in tiles and "GATHER" not in tiles
