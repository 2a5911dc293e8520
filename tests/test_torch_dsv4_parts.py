"""DeepSeek-V4's pieces in the port against the JAX package, on the CPU, on
the tiny model of tests/test_torch_dsv4.py (its fixtures): the mHC mix,
apply and head, the shared expert's clamped three-dot MLP, the clamp in the
plain versions of kernel rows 2 (fused MLP) and 10 (selected experts)
against JAX's kernels in interpret mode, hash routing, and the parameters
carried across from JAX. Tolerances as stated in each test, relative to
the reference's largest magnitude."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.modules.module import ForwardCtx as JCtx
from exllamav3_tpu.ops.fused_mlp import fused_mlp_int8 as jfused_mlp
from exllamav3_tpu.ops.moe_gemm import selected_expert_mlp as jselected
from exllamav3_tpu_torch.model import Config, Model
from exllamav3_tpu_torch.modules.module import ForwardCtx
from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8_plain
from exllamav3_tpu_torch.ops.moe_gemm import selected_expert_mlp_plain
from exllamav3_tpu_torch.util.params import params_from_jax
from test_torch_dsv4 import CFG, TOL_SAME, _close, ckpt, models  # noqa: F401 (fixtures)


def test_hyperconnection_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(4)
    streams = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    y = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jblock, pblock = jm.modules[2], pm.modules[2]
    jpost, jcomb, jcol = jblock.attn_hc.mix(jnp.asarray(streams), jm.params)
    post, comb, col = pblock.attn_hc.mix(torch.from_numpy(streams), pm.params)
    for a, b in ((post, jpost), (comb, jcomb), (col, jcol)):
        _close(a.numpy(), b, 1e-5)
    assert torch.allclose(comb.sum(dim=-2), torch.ones(()), atol=1e-3)  # doubly stochastic
    jout = jblock.attn_hc.apply(jnp.asarray(streams), jnp.asarray(y), jpost, jcomb)
    out = pblock.attn_hc.apply(torch.from_numpy(streams), torch.from_numpy(y), post, comb)
    _close(out.numpy(), jout, 1e-5)
    head = pm.modules[-3].forward(torch.from_numpy(streams), pm.params, ForwardCtx())
    jhead = jm.modules[-3].forward(jnp.asarray(streams), jm.params, JCtx())
    _close(head.float().numpy(), np.asarray(jhead, np.float32), 1e-2)


def test_clamped_gated_mlp_matches_jax(models):
    """The shared expert's three-dot path (act_mul_clamped) at the model's
    limit and at a limit of 0.05 that clips most values."""
    jm, pm = models
    x = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jmlp = jm.modules[2].mlp.shared_experts
    pmlp = pm.modules[2].mlp.shared_experts
    for limit in (10.0, 0.05):
        jmlp.act_clamp = pmlp.act_clamp = limit
        ref = np.asarray(jmlp.forward(jx, jm.params, JCtx()), np.float32)
        got = pmlp.forward(xb, pm.params, ForwardCtx()).float().numpy()
        _close(got, ref, 1e-2)
    jmlp.act_clamp = pmlp.act_clamp = CFG["swiglu_limit"]


@pytest.mark.parametrize("clamp", [0.0, 10.0, 0.5])
def test_clamped_fused_mlp_plain_matches_jax_kernel(clamp):
    """Row 2's plain version with the clamp against JAX's fused kernel in
    interpret mode: the gate clipped to [-L, L] before silu, as that kernel's
    _act does."""
    rng = np.random.default_rng(6)
    m, h, i = 5, 256, 128
    x = torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32)).to(torch.bfloat16)
    gu = rng.integers(-127, 128, (h, 2 * i)).astype(np.int8)
    gs = (rng.random(2 * i) * 0.002 + 0.004).astype(np.float32)
    d = rng.integers(-127, 128, (i, h)).astype(np.int8)
    ds = np.ones(h, np.float32)
    ref = np.asarray(jfused_mlp(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(gu), jnp.asarray(gs), jnp.asarray(d), jnp.asarray(ds),
                                act_clamp=clamp, interpret=True))
    got = fused_mlp_int8_plain(x, torch.from_numpy(gu), torch.from_numpy(gs), torch.from_numpy(d),
                               act_clamp=clamp).numpy()
    _close(got, ref, 2e-3)


@pytest.mark.parametrize("clamp", [0.0, 10.0, 0.5])
def test_clamped_selected_experts_plain_matches_jax_kernel(clamp):
    """Row 10's plain version with min(silu(g), L) * clip(u, -L, L) against
    JAX's selected-expert kernel in interpret mode."""
    rng = np.random.default_rng(7)
    T, h, i, E, k = 3, 128, 128, 4, 2
    x = torch.from_numpy(rng.standard_normal((T, h)).astype(np.float32)).to(torch.bfloat16)
    topi = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    topv = rng.random((T, k)).astype(np.float32)
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) / 8).to(torch.bfloat16)
          for s in ((E, h, i), (E, h, i), (E, i, h))]
    jw = [jnp.asarray(w.float().numpy()).astype(jnp.bfloat16) for w in ws]
    ref = np.asarray(jselected(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(topi), jnp.asarray(topv), jw[1], jw[2], wg=jw[0],
                               act_clamp=clamp, interpret=True))
    got = selected_expert_mlp_plain(x, torch.from_numpy(topi), torch.from_numpy(topv), *ws,
                                    act_clamp=clamp).numpy()
    _close(got, ref, 2e-3)


def test_hash_routing_matches_jax(models):
    """Layer 0 routes by token id through the frozen table, weighted by the
    sqrt-softplus affinity; layer 1 through the learned router. Both MoE
    modules against JAX's on the same rows and ids."""
    jm, pm = models
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 6, 64)).astype(np.float32)).to(torch.bfloat16)
    ids = rng.integers(0, 256, (1, 6)).astype(np.int32)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    for li in (0, 1):
        jmoe, pmoe = jm.modules[2 + li].mlp, pm.modules[2 + li].mlp
        assert ("tid2eid" in pm.params[pmoe.key]) == (li == 0)
        jctx = JCtx()
        jctx.extras["input_ids"] = jnp.asarray(ids)
        ref = np.asarray(jmoe.forward(jx, jm.params, jctx), np.float32)
        got = pmoe.forward(x, pm.params, ForwardCtx(input_ids=torch.from_numpy(ids)))
        _close(got.float().numpy(), ref, 1e-2)
    # equal logits: the table's experts share the weight; a row whose table
    # names one expert twice weights it once (the JAX package's scatter)
    topi = pm.params["layers.0.ffn"]["tid2eid"][torch.from_numpy(ids[0]).long()]
    w = pm.modules[2].mlp.route_hash(torch.zeros((6, 4)), topi)
    for row, experts in zip(w, topi.tolist()):
        assert set(torch.nonzero(row).flatten().tolist()) == set(experts)
        share = CFG["routed_scaling_factor"] / len(experts)
        assert torch.allclose(row.sum(), torch.tensor(share * len(set(experts))))


def test_params_from_jax_carries_the_new_keys(models):
    """sinks, ape and the mHC tensors carry with the JAX parameters; the hash
    table comes from the checkpoint."""
    jm, _ = models
    pm = Model.from_config(Config.from_directory(os.path.dirname(jm.config.directory) + "/port"),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    p = pm.params
    assert p["layers.0.attn"]["sinks"].shape == (4,)
    assert p["layers.1.attn.compressor"]["ape"].shape == (4, 64)
    assert set(p["layers.2.hc_ffn"]) == {"fn", "base", "scale"}
    assert p["layers.0.ffn"]["tid2eid"].shape == (256, 2) and "tid2eid" not in p["layers.1.ffn"]
    ids = np.random.default_rng(9).integers(0, 250, size=(2, 14)).astype(np.int32)
    _close(pm.forward_simple(ids).numpy(), np.asarray(jm.forward_simple(ids)), TOL_SAME)
