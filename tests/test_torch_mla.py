"""The port's MLA pieces against the JAX package, on the CPU: the rope's GPTJ
style and yarn scaling, the latent attention's plain versions against the JAX
kernel in its MLA form (interpret mode), paged and linear, bf16 and quantized
with the JAX cache state carried across, and the MLAttention module on the
same parameters, cacheless and over a linear and a paged cache. The CUDA
latent kernels are held against the plain versions on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.conversion.synth import write_synth_dense_for_arch
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu.modules.mla_attn import MLAttention as JMLA
from exllamav3_tpu.modules.module import ForwardCtx as JCtx
from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu.ops.kv_quant import quantize_kv as jquantize
from exllamav3_tpu.util import rope as jrope
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.modules.mla_attn import MLAttention
from exllamav3_tpu_torch.modules.module import ForwardCtx
from exllamav3_tpu_torch.ops.flash_attention import (latent_attention_any,
                                                      latent_attention_plain,
                                                      latent_attention_quant_plain)
from exllamav3_tpu_torch.ops.kv_quant import quantize_kv, rotate_groups
from exllamav3_tpu_torch.util import rope as prope
from exllamav3_tpu_torch.util.params import _np_to_torch, cache_state_from_jax, params_from_jax

# deepseek-ai/DeepSeek-V2-Lite's rope scaling
V2_YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
           "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096, "type": "yarn"}
ROPE_CASES = {
    "neox-default": ("NEOX", None, False),
    "gptj-default": ("GPTJ", None, False),
    "gptj-yarn-v2lite-ratio": ("GPTJ", V2_YARN, True),
    "gptj-yarn-mscale": ("GPTJ", dict(V2_YARN, mscale=1.0, mscale_all_dim=0.0), True),
    "gptj-yarn-no-ratio": ("GPTJ", V2_YARN, False),
    "neox-yarn-attention-factor": ("NEOX", dict(V2_YARN, attention_factor=0.8, truncate=False),
                                   False),
}


@pytest.mark.parametrize("name", list(ROPE_CASES))
def test_rope_matches_jax(name):
    """compute_rope_params and Rope.apply against JAX's on a 64-wide rope
    slice (DeepSeek's qk_rope_head_dim), positions up to 4095, within 1e-6."""
    style, scaling, ratio = ROPE_CASES[name]
    kw = dict(head_dim=64, rope_theta=10000.0, rope_scaling=scaling, yarn_mscale_ratio=ratio)
    js = jrope.RopeSettings(rope_style=jrope.RopeStyle[style], **kw)
    ps = prope.RopeSettings(rope_style=prope.RopeStyle[style], **kw)
    jinv, jfac = jrope.compute_rope_params(js)
    pinv, pfac = prope.compute_rope_params(ps)
    np.testing.assert_allclose(pinv, jinv, rtol=1e-12, atol=0)
    assert abs(pfac - jfac) <= 1e-12
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 16)).astype(np.int32)
    jr, pr = jrope.Rope(js), prope.Rope(ps)
    jsin, jcos = jr.sin_cos(jnp.asarray(pos))
    ref = np.asarray(jr.apply(jnp.asarray(x), jsin, jcos))
    psin, pcos = pr.sin_cos(torch.from_numpy(pos))
    got = pr.apply(torch.from_numpy(x), psin, pcos).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# test_flash_attention.py::test_mla_latent's shapes: B = 2, Hq = 16, c = 128, dr = 64
B, HQ, C, DR = 2, 16, 128, 64
# (layout, latent bits, compander, rows of q a sequence)
LATENT_CASES = [("paged", 0, 0.0, 1), ("paged", 4, 0.0, 1), ("paged", 3, 0.0, 5),
                ("paged", 4, 0.65, 5), ("linear", 0, 0.0, 5), ("linear", 4, 0.0, 1),
                ("linear", 3, 0.0, 1)]


@pytest.mark.parametrize("layout,bits,compand,S", LATENT_CASES,
                         ids=[f"{l}-{b}bit-a{a}-S{s}" for l, b, a, s in LATENT_CASES])
def test_latent_attention_plain_matches_jax_kernel(layout, bits, compand, S):
    """The plain latent attention against JAX's flash_attention(latent=c) in
    interpret mode on the same bf16 q and the same cache state (the JAX
    package's quantized words and scales carried across), at 2e-3 (the JAX
    test's own tolerance): decode (S = 1) and a verify-shaped chunk (S = 5)."""
    rng = np.random.default_rng(4 + bits)
    D = C + DR
    q = jnp.asarray(rng.standard_normal((B, S, HQ, D)).astype(np.float32) * 0.2, jnp.bfloat16)
    qpos = np.array([[300], [120]], np.int32) - (S - 1) + np.arange(S, dtype=np.int32)[None]
    total = qpos[:, -1] + 1
    if layout == "paged":
        raw = rng.standard_normal((4, 256, 1, D)).astype(np.float32) * 0.3
        bt = np.array([[1, 2], [3, 0]], np.int32)
        where = dict(block_tables=jnp.asarray(bt))
        pwhere = dict(block_tables=torch.from_numpy(bt))
    else:
        raw = rng.standard_normal((B, 304, 1, D)).astype(np.float32) * 0.3
        where, pwhere = {}, {}
    if bits:
        lat_q, lat_s = jquantize(jnp.asarray(raw[..., :C]), bits, compand)
        state = {"kv_q": lat_q, "kv_s": lat_s, "k_pe": jnp.asarray(raw[..., C:], jnp.bfloat16)}
    else:
        state = {"kv": jnp.asarray(raw, jnp.bfloat16)}
    scale = D ** -0.5
    ref = np.asarray(jflash(q, state, jnp.asarray(qpos), jnp.asarray(total), scale=scale,
                            latent=C, k_bits=bits, compand_a=compand, interpret=True, **where))
    pstate = {n: _np_to_torch(np.asarray(t)) for n, t in state.items()}
    pq = _np_to_torch(np.asarray(q))
    args = (torch.from_numpy(qpos), torch.from_numpy(total))
    if bits:
        got = latent_attention_quant_plain(pq, pstate, *args, bits, compand, scale=scale,
                                           **pwhere)
    else:
        got = latent_attention_plain(pq, pstate["kv"], *args, C, scale=scale, **pwhere)
    assert got.shape == (B, S, HQ, C)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)
    # the dispatch picks the same plain version for CPU tensors
    again = latent_attention_any(pq, pstate, *args, C, k_bits=bits, compand_a=compand,
                                 scale=scale, **pwhere)
    assert torch.equal(again, got)


def test_latent_attention_rows_and_empty_rows():
    """Linear layout with named cache rows: a sequence reads its own row; a
    row that sees no key (total length 0) gives 0."""
    rng = np.random.default_rng(9)
    D = C + DR
    kv = torch.from_numpy(rng.standard_normal((3, 40, 1, D)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, D)).astype(np.float32)).to(torch.bfloat16)
    qpos = torch.tensor([[20], [5]], dtype=torch.int32)
    total = torch.tensor([21, 0], dtype=torch.int32)
    rows = torch.tensor([2, 0], dtype=torch.int32)
    got = latent_attention_plain(q, kv, qpos, total, C, rows=rows, scale=0.1)
    ref = latent_attention_plain(q[:1], kv[2:3], qpos[:1], total[:1], C, scale=0.1)
    torch.testing.assert_close(got[:1], ref, rtol=0, atol=0)
    assert torch.count_nonzero(got[1]) == 0


def _mla_cfg(q_lora_rank=None):
    """tests/test_mla.py's geometry: h 128, 4 heads, c 64, nope / rope / v 32."""
    cfg = dict(architectures=["DeepseekV2ForCausalLM"], bos_token_id=1, eos_token_id=2,
               vocab_size=512, hidden_size=128, intermediate_size=256,
               max_position_embeddings=4096, num_attention_heads=4, num_hidden_layers=1,
               rms_norm_eps=1e-5, rope_theta=10000.0, torch_dtype="bfloat16", hidden_act="silu",
               kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32,
               n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               moe_intermediate_size=64, first_k_dense_replace=1, norm_topk_prob=False,
               scoring_func="softmax", rope_scaling=V2_YARN)
    if q_lora_rank:
        cfg["q_lora_rank"] = q_lora_rank
    return cfg


@pytest.fixture(scope="module", params=[None, 48], ids=["q_proj", "q_lora"])
def mla_pair(request, tmp_path_factory):
    """(JAX model, port model on JAX's parameters) of a one-layer
    DeepSeek-V2 model (bf16 weights, yarn rope)."""
    d = str(tmp_path_factory.mktemp("torch_mla") / "m")
    write_synth_dense_for_arch(d, _mla_cfg(request.param), seed=7)
    jm = JModel.from_config(JConfig.from_directory(d))
    jm.load()
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="bf16")),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _attn(model, cls):
    return next(m for m in model.root.walk() if isinstance(m, cls))


def _close(got, ref, tag):
    ref = np.asarray(ref, np.float32)
    assert np.abs(got.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max(), tag


@pytest.mark.parametrize("where", ["cacheless", "linear", "paged", "paged-4bit"])
def test_mla_module_matches_jax(mla_pair, where, monkeypatch):
    """MLAttention on the same input: cacheless, and over a cache a prefill
    chunk of 10 tokens and a decode step on two sequences (JAX's latent
    attention on its dense path, which the latent test above holds its kernel
    to), within 1e-2 of the output's largest value; the port's cache holds
    JAX's bf16 rows and scales after each step."""
    monkeypatch.setenv("EXL3_TPU_ATTN", "dense")
    jm, pm = mla_pair
    ja, pa = _attn(jm, JMLA), _attn(pm, MLAttention)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 128)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    pxb = _np_to_torch(np.asarray(xb))
    if where == "cacheless":
        pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
        ref = jax.jit(lambda x, p, pos: ja.forward(x, p, JCtx(positions=pos)))(
            xb, jm.params, jnp.asarray(pos))
        got = pa.forward(pxb, pm.params, ForwardCtx(positions=torch.from_numpy(pos.copy())))
        _close(got, ref, where)
        return
    bits = 4 if where.endswith("4bit") else 0
    paged = where.startswith("paged")
    spec = (dict(layout="paged", num_pages=4) if paged
            else dict(layout="linear", batch_size=2, max_len=40))
    jstate = JCache(jm, JCacheSpec(**spec, k_bits=bits, v_bits=bits)).state
    cache = Cache(pm, CacheSpec(**spec, k_bits=bits, v_bits=bits))
    bt = np.array([[1, 0], [2, 3]], np.int32)

    @jax.jit
    def jstep(x, params, state, pos, seqlens):
        ctx = JCtx(positions=pos, attn_mode="paged" if paged else "dense", cache=dict(state),
                   k_bits=bits, v_bits=bits, block_tables=jnp.asarray(bt) if paged else None,
                   cache_seqlens=seqlens)
        return ja.forward(x, params, ctx), ctx.cache

    for sl in (slice(0, 10), slice(10, 11)):
        S = sl.stop - sl.start
        pos = np.broadcast_to(np.arange(sl.start, sl.stop, dtype=np.int32), (2, S)).copy()
        seqlens = np.full(2, sl.start, np.int32)
        pctx = ForwardCtx(positions=torch.from_numpy(pos), attn_mode="paged" if paged else "linear",
                          cache=cache.state, k_bits=bits, v_bits=bits,
                          block_tables=torch.from_numpy(bt) if paged else None,
                          cache_seqlens=torch.from_numpy(seqlens))
        ref, jstate = jstep(xb[:, sl], jm.params, jstate, jnp.asarray(pos), jnp.asarray(seqlens))
        got = pa.forward(pxb[:, sl], pm.params, pctx)
        _close(got, ref, (where, sl))
        for name, t in jstate[ja.key].items():
            stored = cache.state[pa.key][name]
            if name != "kv_q":  # codes may differ where a value sits on a grid edge
                np.testing.assert_allclose(stored.float().numpy(),
                                           np.asarray(t, np.float32), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_latent_quantize_matches_jax(bits):
    """The latent's 512 channels in per-head storage with one head: the
    port's words and scales equal the JAX package's bit for bit, on inputs
    whose rotated values sit inside the quantizer's bins (no grid edge)."""
    rng = np.random.default_rng(40 + bits)
    N = 1 << bits
    q = rng.integers(0, N, (2, 5, 1, 512))
    q[..., ::32] = N - 1
    x = rotate_groups(torch.from_numpy((0.75 * (2 * q + 1 - N) / (N - 1)).astype(np.float32)))
    jw, js = jquantize(jnp.asarray(x.numpy()), bits)
    pw, ps = quantize_kv(x, bits)
    assert pw.shape == (2, 5, 1, 16 * bits) and ps.shape == (2, 5, 1, 16)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ps.float().numpy(), np.asarray(js, np.float32))


@pytest.mark.parametrize("k_bits", [0, 4])
def test_cache_state_carries_across(mla_pair, k_bits):
    """cache_state_from_jax takes a JAX latent cache state, {"kv"} or
    {"kv_q", "kv_s", "k_pe"}, into the port's cache unchanged."""
    jm, pm = mla_pair
    spec = dict(layout="paged", num_pages=3, k_bits=k_bits, v_bits=k_bits)
    jstate = JCache(jm, JCacheSpec(**spec)).state
    rng = np.random.default_rng(5)
    jstate = {key: {n: jnp.asarray(rng.integers(-2**31, 2**31, t.shape), t.dtype)
                    if t.dtype == jnp.int32 else jnp.asarray(rng.standard_normal(t.shape), t.dtype)
                    for n, t in layer.items()} for key, layer in jstate.items()}
    cache = Cache(pm, CacheSpec(**spec))
    cache_state_from_jax(cache, jax.tree.map(np.asarray, jstate))
    for key, layer in jstate.items():
        assert set(cache.state[key]) == set(layer) == ({"kv_q", "kv_s", "k_pe"} if k_bits
                                                       else {"kv"})
        for n, t in layer.items():
            np.testing.assert_array_equal(cache.state[key][n].float().numpy(),
                                          np.asarray(t, np.float32))
