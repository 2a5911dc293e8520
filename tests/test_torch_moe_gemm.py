"""The port's selected-expert MoE MLP (ops/moe_gemm.py) and MoE routing
(modules/block_sparse_mlp.py) against the JAX package on the CPU: the plain
version of the kernel against the Pallas kernel in interpret mode on the same
inputs, each routing variant on the same f32 logits, and top-k ties, which
both packages break toward the lower expert index."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.modules.block_sparse_mlp import BlockSparseMLP as JMoE
from exllamav3_tpu.ops import moe_gemm as J
from exllamav3_tpu_torch.model import InferParams
from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP, top_k
from exllamav3_tpu_torch.ops import moe_gemm as P
from exllamav3_tpu_torch.util.env import moe_backend
from exllamav3_tpu_torch.util.params import _np_to_torch as to_torch

E, H, I = 8, 256, 128


def _bf16(a):
    return np.asarray(jnp.asarray(a, dtype=jnp.bfloat16))


@pytest.fixture(scope="module")
def experts():
    rng = np.random.default_rng(21)
    wg = _bf16(rng.standard_normal((E, H, I)) / np.sqrt(H))
    wu = _bf16(rng.standard_normal((E, H, I)) / np.sqrt(H))
    wd = _bf16(rng.standard_normal((E, I, H)) / np.sqrt(I))
    return wg, wu, wd


def _routing(T, k, seed):
    """Tokens that share experts (ids drawn from a few), and one token whose
    two slots name the same expert, which both packages compute twice."""
    rng = np.random.default_rng(seed)
    topi = np.stack([rng.choice(4, k, replace=False) for _ in range(T)]).astype(np.int32)
    topi[0, :] = 3
    topv = (rng.random((T, k)) + 0.1).astype(np.float32)
    return topi, topv / topv.sum(-1, keepdims=True)


@pytest.mark.parametrize("T", [1, 4, 15])
def test_plain_matches_jax_kernel(experts, T):
    """Both sides: bf16 x and weights, exact products summed in f32, the
    activation rounded to bf16. The sums run in another order, which can flip
    one activation's bf16 rounding: held to 1e-4 of the output's range."""
    wg, wu, wd = experts
    x = np.random.default_rng(T).standard_normal((T, H)).astype(np.float32)
    topi, topv = _routing(T, 2, T + 1)
    ref = np.asarray(J.selected_expert_mlp(
        jnp.asarray(x), jnp.asarray(topi), jnp.asarray(topv), jnp.asarray(wu), jnp.asarray(wd),
        wg=jnp.asarray(wg), interpret=True))
    got = P.selected_expert_mlp_plain(torch.from_numpy(x), torch.from_numpy(topi),
                                      torch.from_numpy(topv), to_torch(wg), to_torch(wu),
                                      to_torch(wd)).numpy()
    assert got.shape == (T, H) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_dispatcher_takes_the_plain_version_for_cpu_tensors(experts):
    wg, wu, wd = (to_torch(w) for w in experts)
    x = torch.randn(3, H)
    topi, topv = (torch.from_numpy(a) for a in _routing(3, 2, 5))
    before = P.selected_expert_mlp_kernel.launches
    got = P.selected_expert_mlp(x, topi, topv, wu, wd, wg=wg)
    assert torch.equal(got, P.selected_expert_mlp_plain(x, topi, topv, wg, wu, wd))
    assert P.selected_expert_mlp_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors(experts):
    """The wrapper launches the kernel or raises; it never takes the plain
    version by itself, and a refused call counts no launch."""
    wg, wu, wd = (to_torch(w) for w in experts)
    topi, topv = (torch.from_numpy(a) for a in _routing(2, 2, 6))
    before = P.selected_expert_mlp_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        P.selected_expert_mlp_kernel(torch.zeros((2, H), dtype=torch.bfloat16), topi, topv,
                                     wg, wu, wd)
    assert P.selected_expert_mlp_kernel.launches == before


@pytest.mark.parametrize("kw", [dict(wg=None), dict(activation="silu_oai"), dict(act_clamp=7.0),
                                dict(bd=torch.zeros(E, H))],
                         ids=["non-gated", "silu_oai", "clamp", "bias"])
def test_unported_variants_raise(experts, kw):
    wg, wu, wd = (to_torch(w) for w in experts)
    topi, topv = (torch.from_numpy(a) for a in _routing(2, 2, 7))
    args = dict(wg=wg)
    args.update(kw)
    with pytest.raises(NotImplementedError):
        P.selected_expert_mlp(torch.zeros(2, H), topi, topv, wu, wd, **args)


def test_pick_bi_is_jax_s():
    """The dispatch condition reads the JAX kernel's tile; the port's copy
    gives the same tile for every width, at the published configs too."""
    for h in (128, 256, 512, 2048, 4096, 7168):
        for i in (64, 128, 192, 256, 384, 512, 768, 1408, 1536, 2048, 14336):
            assert P._pick_bi(h, i) == J._pick_bi(h, i), (h, i)
    assert P._pick_bi(2048, 768) == 256 and P._pick_bi(4096, 14336) == 128


def test_moe_backend(monkeypatch):
    """auto is the selected body on both devices; interpret names a Pallas
    mode and raises."""
    for value, want in (("auto", "selected"), ("selected", "selected"), ("dense", "dense")):
        monkeypatch.setenv("EXL3_TPU_MOE", value)
        assert moe_backend() == want
    monkeypatch.delenv("EXL3_TPU_MOE")
    assert moe_backend() == "selected"
    monkeypatch.setenv("EXL3_TPU_MOE", "interpret")
    with pytest.raises(ValueError, match="interpret"):
        moe_backend()


def _pair(routing, **kw):
    """The two packages' MoE modules with one set of routing options (no
    checkpoint: routing reads no weights)."""
    cfg_p = SimpleNamespace(stc=None, infer_params=InferParams())
    cfg_j = SimpleNamespace(stc=None, infer_params=JInferParams())
    args = dict(key="m", hidden_size=H, intermediate_size=I, num_experts=16,
                num_experts_per_tok=4, routing=routing, **kw)
    return BlockSparseMLP(cfg_p, **args), JMoE(cfg_j, **args)


ROUTES = [("std", {}), ("std", dict(norm_topk_prob=False)), ("sigmoid", {}),
          ("std_bias", {}), ("ds3", dict(n_group=4, topk_group=2, routed_scaling_factor=2.5)),
          ("ds3", {}), ("sqrtsp", dict(routed_scaling_factor=1.5)),
          ("group_greedy", dict(n_group=4, topk_group=2)), ("group_greedy", {})]


@pytest.mark.parametrize("routing,kw", ROUTES,
                         ids=[f"{r}-{i}" for i, (r, _) in enumerate(ROUTES)])
def test_route_matches_jax(routing, kw):
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((12, 16)) * 2).astype(np.float32)
    e_bias = (rng.standard_normal(16) * 0.3).astype(np.float32)
    pm, jm = _pair(routing, **kw)
    bias = routing in ("ds3", "sqrtsp")
    ref = np.asarray(jm.route(jnp.asarray(logits), jnp.asarray(e_bias) if bias else None))
    got = pm.route(torch.from_numpy(logits), torch.from_numpy(e_bias) if bias else None).numpy()
    assert ((got > 0) == (ref > 0)).all()
    assert (np.count_nonzero(got, axis=-1) == 4).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("routing", ["std", "sigmoid", "ds3", "group_greedy"])
def test_route_ties_pick_the_lower_index(routing):
    """bf16 router logits tie often at 128 experts. Logits on a coarse grid
    tie at and across the k-th place; both packages keep the lower indices,
    and so does `top_k` for values that tie."""
    rng = np.random.default_rng(9)
    logits = np.round(rng.standard_normal((32, 16)) * 2).astype(np.float32) / 2
    logits[:, 5] = logits[:, 2]
    logits[:, 11] = logits[:, 2]
    kw = dict(n_group=4, topk_group=2) if routing in ("ds3", "group_greedy") else {}
    pm, jm = _pair(routing, **kw)
    ref = np.asarray(jm.route(jnp.asarray(logits)))
    got = pm.route(torch.from_numpy(logits)).numpy()
    assert ((got > 0) == (ref > 0)).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    v, i = top_k(torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 3.0]]), 3)
    assert i.tolist() == [[1, 2, 4]] and v.tolist() == [[3.0, 3.0, 3.0]]
