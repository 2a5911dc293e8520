"""The port's continuous-batching generator against the JAX Generator on the
tiny synthetic Llama with identical int8 weights (CPU): greedy output is
token-identical for concurrent jobs sharing a prefix, with chunked prefill,
and prefix-page reuse matches. Sampling is checked by statistics, since the
two frameworks' random streams differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.generator.batch_sampler import BatchSamplerParams as JParams
from exllamav3_tpu.generator.batch_sampler import batch_sample as jax_batch_sample
from exllamav3_tpu.generator.generator import Generator as JGenerator
from exllamav3_tpu.generator.job import Job as JJob
from exllamav3_tpu.generator.sampler import CustomSampler as JCustomSampler
from exllamav3_tpu.generator.sampler import GreedySampler as JGreedy
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.generator import CustomSampler, Generator, GreedySampler, Job
from exllamav3_tpu_torch.generator.batch_sampler import BatchSamplerParams, batch_sample
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.util.params import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def jax_fused_mlp():
    # decode MLP through the fused kernel (interpret mode), as on the TPU.
    # Token identity needs the same attention arithmetic on both sides: JAX
    # on the CPU takes its dense paged path, which rounds q to bf16, so the
    # port is fed the same rounded q (its own f32-q path is held to JAX's
    # kernel in test_torch_model.py::test_paged_step_matches_jax)
    import exllamav3_tpu_torch.modules.attn as pattn

    orig = pattn.paged_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EXL3_TPU_MLP", "interpret")
        mp.setattr(pattn, "paged_attention",
                   lambda q, *a, **kw: orig(q.to(torch.bfloat16).float(), *a, **kw))
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_gen") / "m"), seed=11)
    jm = JModel.from_config(JConfig.from_directory(d, infer_params=JInferParams(linear_mode="int8")))
    jm.load()
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="int8")),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _run(gen, job_cls, sampler, waves):
    """Enqueue each wave once the previous one has finished; returns
    {prompt index: (new tokens, cached tokens)}."""
    out, idx = {}, 0
    for wave in waves:
        jobs = [job_cls(np.asarray(p), max_new_tokens=8, sampler=sampler, identifier=idx + i)
                for i, p in enumerate(wave)]
        idx += len(wave)
        gen.enqueue(jobs)
        while gen.num_remaining_jobs():
            for r in gen.iterate():
                if r["stage"] == "finished":
                    out[r["identifier"]] = (list(r["new_tokens"]), r["cached_tokens"])
    return out


def test_greedy_matches_jax_generator(models):
    jm, pm = models
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 512, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, n)]) for n in (5, 23, 40, 61, 9, 30)]
    waves = [prompts[:4], prompts[4:]]  # 4 concurrent jobs, then 2 that find the prefix cached
    jgen = JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=24)), max_chunk_size=64)
    pgen = Generator(pm, Cache(pm, CacheSpec(num_pages=24)), max_chunk_size=64)
    ref = _run(jgen, JJob, JGreedy(), waves)
    got = _run(pgen, Job, GreedySampler(), waves)
    assert got == ref
    assert all(got[i][1] == 256 for i in (4, 5))  # prefix page reused


def _expected_probs(logits, temperature, top_k, top_p):
    x = logits / temperature
    order = np.argsort(-x)
    keep = np.zeros_like(x, bool)
    keep[order[:top_k]] = True
    p = np.exp(x[order] - x[order].max())
    p /= p.sum()
    cum = np.cumsum(p)
    keep[order[(cum - p) >= top_p]] = False
    e = np.where(keep, np.exp(x - x.max()), 0.0)
    return e / e.sum()


def test_sampling_statistics():
    """Temperature + top-k + top-p rows sample the truncated softmax in both
    packages; greedy rows take the argmax."""
    rng = np.random.default_rng(4)
    V, N = 300, 20000
    logits = (rng.standard_normal(V) * 2).astype(np.float32)
    expect = _expected_probs(logits, 0.8, 12, 0.9)
    rows = np.broadcast_to(logits, (N, V)).copy()
    counts = np.zeros((N, V), np.int32)

    sp = BatchSamplerParams.from_samplers(
        [CustomSampler(temperature=0.8, top_k=12, top_p=0.9)] * (N - 1) + [GreedySampler()])
    g = torch.Generator().manual_seed(0)
    toks = batch_sample(torch.from_numpy(rows), sp.as_device("cpu"), torch.from_numpy(counts), g).numpy()
    assert toks[-1] == logits.argmax()
    emp = np.bincount(toks[:-1], minlength=V) / (N - 1)

    jsp = JParams.from_samplers(
        [JCustomSampler(temperature=0.8, top_k=12, top_p=0.9)] * (N - 1) + [JGreedy()]).as_device()
    jtoks = np.asarray(jax_batch_sample(jnp.asarray(rows), jsp, jnp.asarray(counts),
                                        jax.random.PRNGKey(0)))
    jemp = np.bincount(jtoks[:-1], minlength=V) / (N - 1)
    # total variation of 20000 draws from a ~10-way distribution: ~0.01
    assert 0.5 * np.abs(emp - expect).sum() < 0.03
    assert 0.5 * np.abs(jemp - expect).sum() < 0.03
    assert set(np.nonzero(emp)[0]) <= set(np.nonzero(expect)[0])


def test_repetition_penalty_statistics():
    """A seen token's positive logit is divided by rep_p in both packages."""
    V, N = 256, 20000  # JAX's sampler needs V >= its top-k width of 256
    logits = np.full(V, -40.0, np.float32)
    logits[:4] = [1.0, 1.0, 0.5, -0.5]
    counts = np.zeros((N, V), np.int32)
    counts[:, 0] = 1
    x = logits.copy()
    x[0] /= 1.5
    expect = np.exp(x) / np.exp(x).sum()
    rows = np.broadcast_to(logits, (N, V)).copy()
    sp = BatchSamplerParams.from_samplers([CustomSampler(rep_p=1.5)] * N)
    toks = batch_sample(torch.from_numpy(rows), sp.as_device("cpu"), torch.from_numpy(counts),
                        torch.Generator().manual_seed(1)).numpy()
    jsp = JParams.from_samplers([JCustomSampler(rep_p=1.5)] * N).as_device()
    jtoks = np.asarray(jax_batch_sample(jnp.asarray(rows), jsp, jnp.asarray(counts),
                                        jax.random.PRNGKey(1)))
    for t in (toks, jtoks):
        emp = np.bincount(t, minlength=V) / N
        assert 0.5 * np.abs(emp - expect).sum() < 0.02


@pytest.mark.parametrize("decode_burst", [1, 8])
@pytest.mark.parametrize("a_new,reused", [(1, 0), (2, 256)])
def test_prefix_reuse_waits_for_the_written_slot(tmp_path, a_new, reused, decode_burst):
    """Job A (255 prompt tokens) completes page 0 with its first decoded
    token, whose K/V only the next forward writes. With one new token A ends
    there, so page 0 must not be offered for reuse; with two, a forward wrote
    it and job B (A's 256 tokens and 40 more) reuses it. Either way B's 8
    greedy tokens equal B's tokens on a fresh generator, exactly. In a burst
    the tokens are taken in step order, so the same holds: A's row steps on
    past its end, but a page registers only once a step wrote its last
    slot."""
    d = write_tiny_llama_exl3(str(tmp_path / "m"), seed=11)
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="bf16")),
                           device="cpu")
    pm.load()

    def gen():
        return Generator(pm, Cache(pm, CacheSpec(num_pages=8)), max_batch_size=4,
                         decode_burst=decode_burst)

    def run(g, ids, n):
        job = Job(ids, max_new_tokens=n, sampler=GreedySampler())
        g.enqueue(job)
        while g.num_remaining_jobs():
            g.iterate()
        return list(job.new_tokens), job.cached_tokens

    rng = np.random.default_rng(0)
    a_ids = rng.integers(0, 512, 255)
    g = gen()
    a_out, _ = run(g, a_ids, a_new)
    b_ids = np.concatenate([a_ids, a_out[:1], rng.integers(0, 512, 40)])
    got, cached = run(g, b_ids, 8)
    ref, _ = run(gen(), b_ids, 8)
    assert cached == reused
    assert got == ref
