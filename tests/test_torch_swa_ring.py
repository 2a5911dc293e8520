"""The SWA ring in the port against the JAX package, on the CPU: the ring
decode op (its plain version, which the CPU path runs) against JAX's ring
kernel in interpret mode and its dense ring path, the ring's state after a
step, and the generator over the ring against the full-length cache, with
slot reuse and n-gram speculative decoding, on the JAX package's own tiny
Gemma-2 fixture (window 8, tests/test_swa_ring.py).

The JAX side's attention takes its kernels (EXL3_TPU_ATTN=interpret), whose
q is f32 as the port's is; its dense ring path (prefill chunks) rounds q to
bf16, and the port is given the same rounded q there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.conversion.synth import write_synth_dense_for_arch
from exllamav3_tpu.generator import Generator as JGenerator
from exllamav3_tpu.generator.job import Job as JJob
from exllamav3_tpu.generator.sampler import GreedySampler as JGreedy
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu.ops.attention import attend_dense as jattend_dense
from exllamav3_tpu.ops.flash_attention import flash_ring_attention
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, Model
from exllamav3_tpu_torch.ops.flash_attention import ring_attention, ring_attention_plain
from exllamav3_tpu_torch.util.params import _np_to_torch, cache_state_from_jax, params_from_jax

# tests/test_swa_ring.py's fixture
CFG = dict(
    architectures=["Gemma2ForCausalLM"], bos_token_id=2, eos_token_id=1,
    vocab_size=512, hidden_size=128, intermediate_size=256,
    max_position_embeddings=4096, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, rms_norm_eps=1e-5,
    rope_theta=10000.0, torch_dtype="bfloat16", head_dim=32,
    hidden_act="gelu_pytorch_tanh", sliding_window=8,
    query_pre_attn_scalar=32, attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0, tie_word_embeddings=True,
)


@pytest.fixture(scope="module", autouse=True)
def jax_kernels():
    # JAX's dense ring path (a prefill chunk over the ring) rounds q to bf16;
    # the port's keeps q in f32, as its kernels take it: the port is fed the
    # same rounded q there (its cacheless path rounds q already)
    import exllamav3_tpu_torch.modules.attn as pattn

    dense = pattn.attend_dense
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pattn, "attend_dense",
                   lambda q, *a, **kw: dense(q.to(torch.bfloat16), *a, **kw))
        mp.setenv("EXL3_TPU_ATTN", "interpret")
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_ring") / "g2")
    write_synth_dense_for_arch(d, CFG, seed=19)
    jm = JModel.from_config(JConfig.from_directory(d))
    jm.load()
    pm = Model.from_config(Config.from_directory(d), device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


# -- the ring decode op ------------------------------------------------------------

def _ring_case(rng, B, N, W, Hq, Hk, D, window, wrapped: bool):
    """Rings holding what a generator leaves in them: each sequence's last W
    positions at slot position % W, some slots never written (-1), some
    holding a stale speculative write (a future position), and a slot table
    that is a permutation of some of the rows."""
    k = rng.standard_normal((N, W, Hk, D)).astype(np.float32)
    v = rng.standard_normal((N, W, Hk, D)).astype(np.float32)
    pos = np.full((N, W), -1, np.int32)
    slots = rng.permutation(N)[:B].astype(np.int32)
    qpos = np.zeros((B, 1), np.int32)
    for b, row in enumerate(slots):
        p = int(rng.integers(W + 3, 4 * W)) if wrapped or b % 2 else int(rng.integers(1, W - 3))
        qpos[b, 0] = p
        for t in range(max(0, p - W + 1), p + 1):
            pos[row, t % W] = t
        for t in range(p + 1, p + 1 + int(rng.integers(0, 4))):  # stale drafts
            pos[row, t % W] = t
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    return q, k, v, pos, slots, qpos


RING_CASES = {
    "wrapped": dict(B=3, N=5, Hq=4, Hk=2, D=32, window=8),
    "filling": dict(B=2, N=4, Hq=4, Hk=2, D=64, window=12, wrapped=False),
    "group3-sinks": dict(B=3, N=4, Hq=6, Hk=2, D=32, window=8, sinks=True),
    "softcap50": dict(B=2, N=3, Hq=4, Hk=1, D=64, window=16, softcap=50.0),
    "sinks-softcap-mha": dict(B=4, N=6, Hq=2, Hk=2, D=32, window=8, sinks=True, softcap=30.0),
    "no-window": dict(B=2, N=3, Hq=4, Hk=2, D=32, window=0),
}


def _ring_inputs(name):
    c = dict(RING_CASES[name])
    rng = np.random.default_rng(sorted(RING_CASES).index(name))
    window = c.pop("window")
    W = (window or 24) + 17
    W += (-W) % 8
    q, k, v, pos, slots, qpos = _ring_case(rng, c["B"], c["N"], W, c["Hq"], c["Hk"], c["D"],
                                           window, c.get("wrapped", True))
    sinks = (rng.standard_normal(c["Hq"]).astype(np.float32) if c.get("sinks") else None)
    kw = dict(scale=c["D"] ** -0.5, sliding_window=window, logit_softcap=c.get("softcap", 0.0))
    return q, k, v, pos, slots, qpos, sinks, kw


def _port_ring(q, k, v, pos, slots, qpos, sinks, kw):
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return ring_attention_plain(torch.from_numpy(q), bf(k), bf(v), torch.from_numpy(pos),
                                torch.from_numpy(slots), torch.from_numpy(qpos),
                                sinks=None if sinks is None else torch.from_numpy(sinks),
                                **kw).numpy()


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_plain_matches_jax_kernel(name):
    """The plain version against JAX's ring kernel in interpret mode over
    rings with never-written and stale slots and a permuted slot table."""
    q, k, v, pos, slots, qpos, sinks, kw = _ring_inputs(name)
    ref = np.asarray(flash_ring_attention(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(qpos),
        sinks=None if sinks is None else jnp.asarray(sinks), interpret=True, **kw))
    got = _port_ring(q, k, v, pos, slots, qpos, sinks, kw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.ptp(ref))


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_plain_matches_jax_dense(name):
    """The same against JAX's dense attention over each sequence's gathered
    ring row, masked by the stored positions (the JAX module's dense ring
    path, modules/attn.py:331-343, on the state it leaves)."""
    q, k, v, pos, slots, qpos, sinks, kw = _ring_inputs(name)
    kb = jnp.asarray(k, jnp.bfloat16)[slots]
    vb = jnp.asarray(v, jnp.bfloat16)[slots]
    kp = jnp.asarray(pos)[slots]
    ref = np.asarray(jattend_dense(jnp.asarray(q), kb, vb, jnp.asarray(qpos), kp, kp >= 0,
                                   sinks=None if sinks is None else jnp.asarray(sinks), **kw))
    got = _port_ring(q, k, v, pos, slots, qpos, sinks, kw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.ptp(ref))
    # the dispatcher takes the plain version for CPU tensors, bit for bit
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    disp = ring_attention(torch.from_numpy(q), bf(k), bf(v), torch.from_numpy(pos),
                          torch.from_numpy(slots), torch.from_numpy(qpos),
                          sinks=None if sinks is None else torch.from_numpy(sinks), **kw)
    assert torch.equal(disp, torch.from_numpy(got))


def test_ring_attention_row_without_keys_is_zero():
    """A ring row that holds nothing visible (every slot -1, or only future
    positions) gives 0, as the kernel does."""
    q = torch.ones((2, 1, 2, 32))
    ring = torch.ones((2, 16, 1, 32), dtype=torch.bfloat16)
    pos = torch.full((2, 16), -1, dtype=torch.int32)
    pos[1, 3] = 9
    out = ring_attention_plain(q, ring, ring, pos, torch.tensor([0, 1], dtype=torch.int32),
                               torch.tensor([[5], [5]], dtype=torch.int32), scale=0.2)
    assert torch.equal(out, torch.zeros_like(out))


# -- the ring's state ---------------------------------------------------------------

def test_ring_state_after_steps_matches_jax(models):
    """A 40-token prefill chunk (longer than the ring's W = 32 slots: only its
    last 32 positions are written) and three decode steps, in state slot 2 of
    3: the port's ring state equals JAX's bit for bit after every step and the
    logits agree. Then JAX's state carried across gives the port's next step
    the same logits."""
    jm, pm = models
    step = jax.jit(jm.step_fn("paged"))
    spec = dict(layout="paged", num_pages=4, swa_ring=True, recurrent_slots=3)
    jcache = JCache(jm, JCacheSpec(**spec))
    cache = Cache(pm, CacheSpec(**spec))
    ring_key = "model.layers.0.self_attn"
    assert set(cache.state[ring_key]) == {"k", "v", "pos"}
    assert cache.state[ring_key]["k"].shape == (3, 32, 2, 32)
    assert set(cache.state["model.layers.1.self_attn"]) == {"k", "v"}
    bt = np.array([[1, 2, 0]], np.int32)
    slots = np.array([2], np.int32)
    ids = np.random.default_rng(3).integers(0, 512, size=(1, 44)).astype(np.int32)
    chunks = [(ids[:, :40], np.arange(40, dtype=np.int32)[None], np.array([0], np.int32))]
    chunks += [(ids[:, p: p + 1], np.array([[p]], np.int32), np.array([p], np.int32))
               for p in range(40, 43)]
    for x, pos, seqlens in chunks:
        ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt,
                                 jnp.asarray(slots))
        got = pm.forward(x, cache, pos, seqlens, bt, state_slots=slots).numpy()
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
        for name, arr in jcache.state[ring_key].items():
            theirs = _np_to_torch(np.asarray(arr))
            ours = cache.state[ring_key][name]
            if name == "pos":
                assert torch.equal(ours, theirs)
            else:  # the K/V values, rounded to bf16 from f32 sums in another order
                np.testing.assert_allclose(ours.float().numpy(), theirs.float().numpy(),
                                           rtol=0, atol=2e-2 * float(theirs.float().abs().max()))
    pos_row = cache.state[ring_key]["pos"][2]
    assert sorted(pos_row.tolist()) == list(range(11, 43))
    assert (cache.state[ring_key]["pos"][:2] == -1).all()
    cache_state_from_jax(cache, jax.tree.map(np.asarray, jcache.state))
    x, pos, seqlens = ids[:, 43:44], np.array([[43]], np.int32), np.array([43], np.int32)
    ref, _ = step(jm.params, x, jcache.state, pos, seqlens, bt, jnp.asarray(slots))
    got = pm.forward(x, cache, pos, seqlens, bt, state_slots=slots).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                               atol=1e-2 * np.abs(np.asarray(ref)).max())


def test_ring_memory_shrinks(models):
    """The sliding layer's ring (5 slots x 32) is far smaller than 8 pages x
    256 tokens (tests/test_swa_ring.py:45)."""
    _, pm = models
    full = Cache(pm, CacheSpec(num_pages=8))
    ring = Cache(pm, CacheSpec(num_pages=8, swa_ring=True, recurrent_slots=5))

    def nbytes(state):
        return sum(t.numel() * t.element_size() for layer in state.values()
                   for t in layer.values())

    assert nbytes(ring.state) < 0.7 * nbytes(full.state)
    ring_layer = {"ring": ring.state["model.layers.0.self_attn"]}
    assert nbytes(ring_layer) == 5 * 32 * (2 * 2 * 32 * 2 + 4)


# -- the generator over the ring -------------------------------------------------------

def _gen(pm, ring, **kw):
    cache = Cache(pm, CacheSpec(num_pages=8, swa_ring=ring, recurrent_slots=5))
    return Generator(pm, cache, max_batch_size=4, **kw)


PROMPT = np.arange(30, dtype=np.int64) % 200 + 3  # spans several windows


def test_ring_matches_full(models):
    """Greedy tokens over the ring equal those over the full-length cache
    (tests/test_swa_ring.py:38)."""
    _, pm = models
    full = _gen(pm, ring=False).generate(PROMPT.copy(), max_new_tokens=20)
    ring = _gen(pm, ring=True).generate(PROMPT.copy(), max_new_tokens=20)
    assert ring == full and len(ring) == 20


def test_ring_generator_matches_jax(models):
    """Two concurrent jobs over the ring, each in its own state slot: the
    port's greedy tokens equal JAX's generator's over its ring."""
    jm, pm = models
    prompts = [PROMPT.copy(), np.random.default_rng(4).integers(3, 400, 19)]
    gen = _gen(pm, ring=True)
    got = gen.generate([p.copy() for p in prompts], max_new_tokens=12)
    jgen = JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=8, swa_ring=True,
                                                recurrent_slots=5)), max_batch_size=4)
    jobs = [JJob(p.copy(), max_new_tokens=12, sampler=JGreedy(), identifier=i)
            for i, p in enumerate(prompts)]
    jgen.enqueue(jobs)
    ref = {}
    while jgen.num_remaining_jobs():
        for r in jgen.iterate():
            if r["stage"] == "finished":
                ref[r["identifier"]] = list(r["new_tokens"])
    assert got == [ref[0], ref[1]]
    assert gen.ring_keys == ["model.layers.0.self_attn"] and gen.pagetable.disable_reuse


def test_ring_slot_reuse(models):
    """A second job in a finished job's slot gets the same tokens: admission
    clears the slot (tests/test_swa_ring.py:58)."""
    _, pm = models
    gen = _gen(pm, ring=True)
    p = np.array([7, 11, 23, 5, 9, 13, 2, 7, 44, 91], np.int64)
    a = gen.generate(p.copy(), max_new_tokens=8)
    layer = gen.cache.state["model.layers.0.self_attn"]
    assert (layer["pos"][0] >= 0).sum() == 17
    b = gen.generate(p.copy(), max_new_tokens=8)
    assert a == b


def test_ring_slot_cleared_on_admission(models):
    """A slot's stale ring (positions, K and V) is gone once a job takes it;
    the prompt's page hashes are not reused."""
    _, pm = models
    gen = _gen(pm, ring=True)
    layer = gen.cache.state["model.layers.0.self_attn"]
    layer["pos"][0] = 3
    layer["k"][0] = 1.0
    gen.enqueue(Job(PROMPT.copy(), max_new_tokens=1, sampler=GreedySampler()))
    gen._admit_jobs([])
    assert (layer["pos"][0] == -1).all() and (layer["k"][0] == 0).all()
    first = gen.generate(PROMPT.copy(), max_new_tokens=2)
    gen.generate(PROMPT.copy(), max_new_tokens=2)
    assert gen.pagetable.cached_tokens_served == 0 and len(first) == 2


def test_ring_needs_a_slot_per_job_and_a_scrap_row(models):
    _, pm = models
    cache = Cache(pm, CacheSpec(num_pages=8, swa_ring=True, recurrent_slots=4))
    with pytest.raises(ValueError, match="recurrent_slots"):
        Generator(pm, cache, max_batch_size=4)
    assert CacheSpec(swa_ring=True).state_slots() == 33
    assert CacheSpec(layout="linear", batch_size=3, swa_ring=True).state_slots() == 3


def test_ring_ngram_sd_matches_plain(models):
    """n-gram speculative decoding over the ring equals plain decoding: the
    ring's headroom keeps a rejected draft's write from evicting a live
    window entry (tests/test_swa_ring.py:66)."""
    _, pm = models
    prompt = np.array([7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8], np.int64)
    ref = _gen(pm, ring=True).generate(prompt.copy(), max_new_tokens=14)
    gen = _gen(pm, ring=True, use_ngram_draft=True, num_draft_tokens=3)
    out = gen.generate(prompt.copy(), max_new_tokens=14)
    assert out == ref
    assert gen.num_drafted > 0 and gen.num_accepted < gen.num_drafted
