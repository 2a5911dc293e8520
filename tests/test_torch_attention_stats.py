"""The port's return_stats attention (kernel row 6b) against the JAX package,
on the CPU: the plain versions of the three stats entries that DeepSeek-V4's
decode step runs, over one shared K = V row, against the JAX kernel in
interpret mode: the sliding ring (flash_ring_attention), a compressed pool of
2-entry pages through a shuffled token block table and selected entries in a
linear layout (flash_attention with `latent`). Also merge_stats against a
dense softmax with sinks, over two halves of one key range.

The JAX kernel masks with a finite NEG_INF, so a row that sees no key in a
tile it walks counts exp(0) for every masked key in l and acc; its merge
drops such a row by m alone. The port writes (0, -1e30, 0) there. On such
rows the tests hold m to JAX's and (acc, l) to zero; on every other row all
three agree within 2e-3, the JAX package's own tolerance for the merge
(tests/test_flash_attention.py::test_return_stats_merge). The CUDA kernels
are held against these plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu.ops.flash_attention import flash_ring_attention as jring
from exllamav3_tpu_torch.ops import flash_attention as F

D, H = 64, 4
SCALE = D ** -0.5
TOL = 2e-3


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 values, kept f32 (the q the kernels take as bf16)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _check(port, jax_out, masked_rows=()):
    acc, m, l = (t.numpy() for t in port)
    jacc, jm, jl = (np.asarray(t) for t in jax_out)
    keep = np.ones(m.shape[0], bool)
    keep[list(masked_rows)] = False
    np.testing.assert_allclose(m, jm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(acc[keep], jacc[keep], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l[keep], jl[keep], rtol=TOL, atol=TOL)
    for b in masked_rows:
        assert (m[b] == F.NEG_INF).all() and (acc[b] == 0).all() and (l[b] == 0).all()


def _ring_inputs(seed=0):
    rng = np.random.default_rng(seed)
    N, W, B = 4, 12, 3
    ring = _bf16(rng.standard_normal((N, W, D)))
    pos = np.full((N, W), -1, np.int32)
    pos[0] = np.arange(30, 42) % 1000          # a full ring
    pos[0, 3] = 55                             # a stale speculative write
    pos[2, :5] = [40, 41, 42, 43, 44]          # a partly written ring
    pos[3, :4] = [90, 91, 92, 93]              # every slot outside the window
    slots = np.array([2, 0, 3], np.int32)
    qpos = np.array([[44], [41], [120]], np.int32)
    q = _bf16(rng.standard_normal((B, 1, H, D)))
    return q, ring, pos, slots, qpos


def test_ring_stats_matches_jax():
    q, ring, pos, slots, qpos = _ring_inputs()
    window = 8
    want = jring(jnp.asarray(q), jnp.asarray(ring[:, :, None]), jnp.asarray(ring[:, :, None]),
                 jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(qpos), scale=SCALE,
                 sliding_window=window, return_stats=True, interpret=True)
    got = F.ring_attention_stats(torch.from_numpy(q).to(torch.bfloat16),
                                 torch.from_numpy(ring).to(torch.bfloat16),
                                 torch.from_numpy(pos), torch.from_numpy(slots),
                                 torch.from_numpy(qpos), scale=SCALE, sliding_window=window)
    _check(got, want, masked_rows=[2])


def _pool_inputs(seed=1):
    rng = np.random.default_rng(seed)
    P, epp, MP, B = 24, 2, 8, 3
    pool = _bf16(rng.standard_normal((P, epp, D)))
    bt = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)  # no identity table
    total = np.array([5, 0, 13], np.int32)
    qpos = (total - 1)[:, None].astype(np.int32)
    q = _bf16(rng.standard_normal((B, 1, H, D)))
    return q, pool, bt, qpos, total


def test_pool_stats_matches_jax_over_shuffled_pages():
    """An HCA-style pool of 2-entry pages, paged through a block table that is
    not the identity: entry j is slot j % 2 of page bt[b, j // 2]."""
    q, pool, bt, qpos, total = _pool_inputs()
    want = jflash(jnp.asarray(q), {"kv": jnp.asarray(pool[:, :, None])}, jnp.asarray(qpos),
                  jnp.asarray(total), block_tables=jnp.asarray(bt), scale=SCALE, latent=D,
                  return_stats=True, interpret=True)
    got = F.pool_attention_stats(torch.from_numpy(q).to(torch.bfloat16),
                                 torch.from_numpy(pool).to(torch.bfloat16), torch.from_numpy(bt),
                                 torch.from_numpy(qpos), torch.from_numpy(total), scale=SCALE)
    _check(got, want, masked_rows=[1])
    # the gather follows the table: a dense softmax over the entries as listed
    kp = pool[bt].reshape(bt.shape[0], -1, D)
    s = np.einsum("bhd,btd->bht", q[:, 0], kp) * SCALE
    for b in (0, 2):
        sb = s[b, :, : total[b]]
        p = np.exp(sb - sb.max(-1, keepdims=True))
        np.testing.assert_allclose(got[0][b, 0].numpy(), p @ kp[b, : total[b]], rtol=TOL, atol=TOL)


def _rows_inputs(seed=2, T=8):
    rng = np.random.default_rng(seed)
    B = 3
    kv = _bf16(rng.standard_normal((B, T, D)))
    vcount = np.array([5, 0, T], np.int32)
    q = _bf16(rng.standard_normal((B, 1, H, D)))
    return q, kv, vcount


def test_rows_stats_matches_jax():
    """The CSA form: the selected entries gathered into rows of 8, the first
    vcount of each visible (fictional positions 0..K-1, the query at
    vcount - 1)."""
    q, kv, vcount = _rows_inputs()
    qpos = (vcount - 1)[:, None]
    want = jflash(jnp.asarray(q), {"kv": jnp.asarray(kv[:, :, None])}, jnp.asarray(qpos),
                  jnp.asarray(vcount), scale=SCALE, latent=D, return_stats=True, interpret=True)
    got = F.rows_attention_stats(torch.from_numpy(q).to(torch.bfloat16),
                                 torch.from_numpy(kv).to(torch.bfloat16),
                                 torch.from_numpy(qpos), torch.from_numpy(vcount), scale=SCALE)
    _check(got, want, masked_rows=[1])


def test_merge_of_two_halves_with_sinks_matches_single_softmax():
    """Two halves of one key range, each attended on its own, merged with the
    sink logits, against one dense softmax over [keys | sink]; a row whose
    range is empty in one half (or in both) merges all the same."""
    T = 16
    q, kv, _ = _rows_inputs(seed=3, T=T)
    vcount = np.array([12, 5, 0], np.int32)
    sinks = torch.from_numpy((np.random.default_rng(4).standard_normal(H) * 0.5).astype(np.float32))
    qt = torch.from_numpy(q).to(torch.bfloat16)
    kvt = torch.from_numpy(kv).to(torch.bfloat16)
    qpos = torch.from_numpy((vcount - 1)[:, None])
    tot = torch.from_numpy(vcount)
    half = T // 2
    one = F.rows_attention_stats(qt, kvt, qpos, tot, scale=SCALE)
    lo = F.rows_attention_stats(qt, kvt[:, :half].contiguous(), qpos,
                                torch.clamp(tot, max=half), scale=SCALE)
    hi = F.rows_attention_stats(qt, kvt[:, half:].contiguous(), qpos - half,
                                torch.clamp(tot - half, min=0), scale=SCALE)
    merged = F.merge_stats([lo, hi], sinks).numpy()
    np.testing.assert_allclose(merged, F.merge_stats([one], sinks).numpy(), rtol=TOL, atol=TOL)
    sk = sinks.numpy()
    for b in range(3):
        s = np.concatenate([np.einsum("hd,td->ht", q[b, 0], kv[b, : vcount[b]]) * SCALE,
                            sk[:, None]], axis=1)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(merged[b, 0], p[:, :-1] @ kv[b, : vcount[b]],
                                   rtol=TOL, atol=TOL)
    assert (merged[2] == 0).all()  # no key: the sink takes the whole softmax


@pytest.mark.parametrize("name", ["ring_attention_stats_kernel", "pool_attention_stats_kernel",
                                  "rows_attention_stats_kernel"])
def test_stats_kernels_refuse_cpu_tensors(name):
    """A kernel wrapper launches or raises: it never runs the plain version."""
    q = torch.zeros((1, 1, 16, F.KV_ROW), dtype=torch.bfloat16)
    i1 = torch.zeros((1, 1), dtype=torch.int32)
    args = {"ring_attention_stats_kernel": (q, torch.zeros((1, 8, F.KV_ROW), dtype=torch.bfloat16),
                                            torch.zeros((1, 8), dtype=torch.int32),
                                            torch.zeros(1, dtype=torch.int32), i1),
            "pool_attention_stats_kernel": (q, torch.zeros((4, 2, F.KV_ROW), dtype=torch.bfloat16),
                                            i1, i1, torch.zeros(1, dtype=torch.int32)),
            "rows_attention_stats_kernel": (q, torch.zeros((1, 8, F.KV_ROW), dtype=torch.bfloat16),
                                            i1, torch.zeros(1, dtype=torch.int32))}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(F, name)(*args)
    assert getattr(F, name).launches == 0
