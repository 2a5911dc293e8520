"""Greedy speculative decoding in the port against plain greedy decoding and
against the JAX package, on the CPU, on the tiny synthetic Llama with
identical bf16 weights (the JAX package's own speculative-decoding tests use
that mode: its decode and verify steps then run the same MLP arithmetic).

JAX takes its dense attention on the CPU, which rounds q to bf16; the port's
attention takes q in f32 (as JAX's kernel path does), so the port is given
the same rounded q, paged and linear, as tests/test_torch_generator.py does."""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.generator.generator import Generator as JGenerator
from exllamav3_tpu.generator.job import Job as JJob
from exllamav3_tpu.generator.ngram import SuffixAutomaton as JSuffixAutomaton
from exllamav3_tpu.generator.sampler import GreedySampler as JGreedy
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.generator.ngram import SuffixAutomaton
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.util.params import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def rounded_q():
    import exllamav3_tpu_torch.modules.attn as pattn

    paged, linear = pattn.paged_attention, pattn.linear_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pattn, "paged_attention",
                   lambda q, *a, **kw: paged(q.to(torch.bfloat16).float(), *a, **kw))
        mp.setattr(pattn, "linear_attention",
                   lambda q, *a, **kw: linear(q.to(torch.bfloat16).float(), *a, **kw))
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_sd") / "m"), seed=11)
    jm = JModel.from_config(JConfig.from_directory(d,
                                                   infer_params=JInferParams(linear_mode="bf16")))
    jm.load()
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="bf16")),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _port(pm, **kw):
    return Generator(pm, Cache(pm, CacheSpec(num_pages=24)), max_batch_size=4, **kw)


def _jax(jm, **kw):
    return JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=24)), max_batch_size=4,
                      **kw)


def _run(gen, job_cls, sampler, prompts, max_new=12):
    """{prompt index: finished event} for prompts enqueued together."""
    jobs = [job_cls(np.asarray(p), max_new_tokens=max_new, sampler=sampler, identifier=i)
            for i, p in enumerate(prompts)]
    gen.enqueue(jobs)
    out = {}
    while gen.num_remaining_jobs():
        for r in gen.iterate():
            if r["stage"] == "finished":
                out[r["identifier"]] = r
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suffix_automaton_drafts_equal_jax(seed):
    """Seeded token streams over a small alphabet (so suffixes repeat): after
    every token both automata propose the same drafts, for every length."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 6 + 3 * seed, 120).tolist()
    ours, theirs = SuffixAutomaton(), JSuffixAutomaton()
    proposed = 0
    for t in stream:
        ours.extend(t)
        theirs.extend(t)
        for k in (1, 4):
            for min_ctx in (1, 2, 3):
                d = ours.draft(k, min_ctx)
                assert d == theirs.draft(k, min_ctx)
                proposed += bool(d)
    assert proposed > 100


def test_draft_model_sd_matches_plain_and_jax(models):
    """The model drafting for itself, one job: the port's SD tokens equal its
    plain greedy tokens and JAX's SD tokens; the acceptance is over 0.8 (the
    JAX package's own bound), and the drafted, accepted and rejected counts
    equal JAX's."""
    jm, pm = models
    prompt = np.random.default_rng(5).integers(0, 400, size=9)
    plain = _run(_port(pm), Job, GreedySampler(), [prompt])[0]["new_tokens"]
    gen = _port(pm, draft_model=pm, num_draft_tokens=3)
    got = _run(gen, Job, GreedySampler(), [prompt])[0]
    jgen = _jax(jm, draft_model=jm, num_draft_tokens=3)
    ref = _run(jgen, JJob, JGreedy(), [prompt])[0]
    assert got["new_tokens"] == plain == list(ref["new_tokens"])
    assert gen.num_accepted / max(gen.num_drafted, 1) > 0.8
    assert (gen.num_drafted, gen.num_accepted) == (jgen.num_drafted, jgen.num_accepted)
    for key in ("accepted_draft_tokens", "rejected_draft_tokens"):
        assert got[key] == ref[key]
    assert gen.draft_cache.spec.layout == "linear"
    assert gen.draft_cache.spec.max_len == 24 * 256 // 4


def test_ngram_sd_matches_plain_greedy(models):
    """A repetitive prompt: the n-gram drafter proposes, and the output is
    plain greedy decoding's."""
    _, pm = models
    rng = np.random.default_rng(4)
    base = rng.integers(0, 400, size=6).tolist()
    prompt = np.asarray(base * 3 + base[:2])
    plain = _run(_port(pm), Job, GreedySampler(), [prompt])[0]["new_tokens"]
    gen = _port(pm, use_ngram_draft=True, num_draft_tokens=4)
    got = _run(gen, Job, GreedySampler(), [prompt])[0]
    assert got["new_tokens"] == plain
    assert gen.num_drafted > 0
    assert got["accepted_draft_tokens"] + got["rejected_draft_tokens"] == gen.num_drafted


def test_draft_model_sd_batch_of_two(models):
    """Two jobs of different lengths, drafted for together: each equals plain
    greedy decoding, and JAX's SD tokens."""
    jm, pm = models
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 400, size=n) for n in (300, 7)]
    plain = _run(_port(pm), Job, GreedySampler(), prompts, max_new=10)
    got = _run(_port(pm, draft_model=pm), Job, GreedySampler(), prompts, max_new=10)
    ref = _run(_jax(jm, draft_model=jm), JJob, JGreedy(), prompts, max_new=10)
    for i in range(2):
        assert got[i]["new_tokens"] == plain[i]["new_tokens"] == list(ref[i]["new_tokens"])


def test_draft_steps_leave_other_jobs_rows_alone(models):
    """The JAX package's fault that the port does not copy: every JAX draft
    step runs all rows of the draft cache, the rows of other jobs with token 0
    at position 0, and so overwrites position 0 of every other job's row. After
    two jobs draft, JAX's row of job A holds, at position 0, the keys of token
    0 and not those of A's first token; the port's row holds A's."""
    jm, pm = models
    rng = np.random.default_rng(8)
    a, b = rng.integers(1, 400, size=12), rng.integers(1, 400, size=10)
    jgen = _jax(jm, draft_model=jm, num_draft_tokens=2)
    gen = _port(pm, draft_model=pm, num_draft_tokens=2)
    for g, job_cls, sampler in ((jgen, JJob, JGreedy()), (gen, Job, GreedySampler())):
        _run(g, job_cls, sampler, [a, b], max_new=4)
    key = gen.draft_cache.layer_keys[0]

    def first_keys(token: int) -> torch.Tensor:
        """The keys the first layer stores for `token` at position 0."""
        c = Cache(pm, CacheSpec(layout="linear", batch_size=1, max_len=8))
        pm.forward(np.array([[token]]), c, np.zeros((1, 1), np.int32), np.zeros(1, np.int32))
        return c.state[key]["k"][0, 0].float()

    row_a = 0  # job A took the first free slot in both generators
    jax_a = torch.from_numpy(np.asarray(jgen.draft_cache.state[key]["k"][row_a, 0],
                                        dtype=np.float32))
    port_a = gen.draft_cache.state[key]["k"][row_a, 0].float()
    own, zero = first_keys(int(a[0])), first_keys(0)
    assert torch.equal(port_a, own)
    assert torch.equal(jax_a, zero) and not torch.equal(jax_a, own)


def test_sd_only_for_greedy_and_refuses_unported_drafters(models):
    """A job that samples keeps the whole batch on plain decoding; a DFlash or
    MTP drafter is refused."""
    from exllamav3_tpu_torch.generator.sampler import DefaultSampler

    _, pm = models
    gen = _port(pm, draft_model=pm)
    prompts = [np.arange(5, 15), np.arange(20, 32)]
    jobs = [Job(prompts[0], max_new_tokens=6, sampler=GreedySampler()),
            Job(prompts[1], max_new_tokens=6, sampler=DefaultSampler())]
    gen.enqueue(jobs)
    while gen.num_remaining_jobs():
        gen.iterate()
    assert gen.num_drafted == 0 and all(len(j.new_tokens) == 6 for j in jobs)
    pm.caps["mtp_draft"] = True
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            _port(pm, draft_model=pm)
    finally:
        pm.caps.clear()
