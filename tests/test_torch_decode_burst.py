"""Decode bursts and the compiled decode step of the port's generator
(generator/decode_graph.py) on the CPU, where the step runs eagerly: the
cases of tests/test_decode_burst.py with exact tokens. A burst of 8 yields the
JAX generator's greedy tokens at decode_burst=8 and the port's single-step
tokens; a stop token inside a burst truncates and takes the dropped tokens'
counts back out, so that token_counts equal the single-step run's; page
pressure drops to single steps; the prefill and the queue caps take effect; a
padded row leaves the real rows' logits as the unpadded step gives them.
Also which steps pad (only those captured), the launch accounting of
replays, the workspace a captured graph holds, which families capture their
decode step, and the MoE decode route of a batch too wide to capture."""
import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.generator.generator import Generator as JGenerator
from exllamav3_tpu.generator.job import Job as JJob
from exllamav3_tpu.generator.sampler import GreedySampler as JGreedy
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu_torch.conversion import synth
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.generator import decode_graph as dg
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP
from exllamav3_tpu_torch.ops import launches
from exllamav3_tpu_torch.util import device as udev
from exllamav3_tpu_torch.util.params import params_from_jax

P1 = (np.arange(30) % 300 + 5).tolist()
P2 = (np.arange(45) % 200 + 9).tolist()


@pytest.fixture(scope="module", autouse=True)
def jax_fused_mlp():
    # as tests/test_torch_generator.py: the decode MLP through JAX's fused
    # kernel in interpret mode, and q rounded to bf16 before the port's paged
    # attention, as JAX's dense paged path on the CPU rounds it
    import exllamav3_tpu_torch.modules.attn as pattn

    orig = pattn.paged_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EXL3_TPU_MLP", "interpret")
        mp.setattr(pattn, "paged_attention",
                   lambda q, *a, **kw: orig(q.to(torch.bfloat16).float(), *a, **kw))
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_burst") / "m"), seed=29)
    jm = JModel.from_config(JConfig.from_directory(d, infer_params=JInferParams(linear_mode="int8")))
    jm.load()
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="int8")),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _run(model, burst, prompts, max_new=21, stop_tokens=None, num_pages=24, max_batch_size=4,
         **kw):
    gen = Generator(model, Cache(model, CacheSpec(num_pages=num_pages)),
                    max_batch_size=max_batch_size, decode_burst=burst, **kw)
    jobs = [Job(np.asarray(p), max_new_tokens=max_new, sampler=GreedySampler(),
                stop_conditions=list(stop_tokens or [])) for p in prompts]
    gen.enqueue(jobs)
    while gen.num_remaining_jobs():
        gen.iterate()
    return [list(j.new_tokens) for j in jobs], gen


def test_burst_matches_jax_and_single_step(models):
    jm, pm = models
    jgen = JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=24)), max_batch_size=4,
                      decode_burst=8)
    jjobs = [JJob(np.asarray(p), max_new_tokens=21, sampler=JGreedy()) for p in (P1, P2)]
    jgen.enqueue(jjobs)
    while jgen.num_remaining_jobs():
        jgen.iterate()
    ref = [list(j.new_tokens) for j in jjobs]
    single, _ = _run(pm, 1, [P1, P2])
    burst, gen = _run(pm, 8, [P1, P2])
    assert burst == single == ref
    assert all(len(t) == 21 for t in burst)  # 21 % 8 != 0: the last burst is partial
    assert gen.decoder.steps == 24 and not gen.decoder.capture


def test_stop_token_truncates_and_reverses_counts(models):
    _, pm = models
    prompts = [(np.arange(24) % 300 + 5).tolist()]
    ref, _ = _run(pm, 1, prompts, max_new=40)
    stop = ref[0][5]
    want = ref[0][: ref[0].index(stop)]
    single, g1 = _run(pm, 1, prompts, max_new=40, stop_tokens=[stop])
    burst, g8 = _run(pm, 8, prompts, max_new=40, stop_tokens=[stop])
    assert single == burst == [want]
    # every dropped token's count came back out: the rows (the scrap row
    # included) equal the single-step run's, prompt + kept tokens + the stop
    np.testing.assert_array_equal(g8.token_counts.numpy(), g1.token_counts.numpy())
    assert int(g8.token_counts[: g8.max_batch_size].sum()) == len(prompts[0]) + len(want) + 1
    assert g1.decoder.steps == len(want) + 1 and g8.decoder.steps == 8  # past the stop


def test_page_pressure_drops_to_single_steps(models, monkeypatch):
    """Three pages: job A's 504-token prompt holds two, job B's 200 the third.
    Once A's burst window reaches past its second page, the window cannot be
    had: decode steps singly (rather than finishing a job for pages it may not
    use) until A overflows the cache, then B bursts again. Tokens and
    finishing reasons equal the single-step run's."""
    _, pm = models
    pa = (np.arange(504) % 300 + 5).tolist()
    pb = (np.arange(200) % 300 + 5).tolist()
    refused = []
    grow = Generator._grow_window

    def spy(self, jobs, extra):
        ok = grow(self, jobs, extra)
        refused.append(not ok)
        return ok
    monkeypatch.setattr(Generator, "_grow_window", spy)

    def run(burst):
        gen = Generator(pm, Cache(pm, CacheSpec(num_pages=4)), max_batch_size=2,
                        decode_burst=burst)
        jobs = [Job(np.asarray(p), max_new_tokens=30, sampler=GreedySampler()) for p in (pa, pb)]
        gen.enqueue(jobs)
        while gen.num_remaining_jobs():
            gen.iterate()
        assert all(p.ref_count == 0 for p in gen.pagetable.pages[1:])  # every page given back
        return [(list(j.new_tokens), j.eos_reason) for j in jobs]

    single = run(1)
    assert not refused
    burst = run(8)
    assert burst == single
    assert single[0][1] == "cache_overflow" and single[1] == (single[1][0], "max_new_tokens")
    assert len(single[1][0]) == 30 and any(refused) and not refused[-1]


def test_prefill_and_queue_caps(models):
    _, pm = models
    # while a prompt is being prefilled, bursts cap at prefill_burst
    gen = Generator(pm, Cache(pm, CacheSpec(num_pages=24)), max_batch_size=2,
                    decode_burst=8, max_chunk_size=128)
    ja = Job(np.asarray(P1), max_new_tokens=18, sampler=GreedySampler())
    gen.enqueue(ja)
    while ja.status != "running":
        gen.iterate()
    jb = Job(np.asarray((np.arange(400) % 200 + 9)), max_new_tokens=6, sampler=GreedySampler())
    gen.enqueue(jb)
    caps = []
    while gen.num_remaining_jobs():
        running = [j for j in gen.active if j.status == "running"]
        if running and any(j.status == "prefill" for j in gen.active):
            caps.append(gen._burst_n(running))
        gen.iterate()
    assert caps and set(caps) == {4}
    ref, _ = _run(pm, 1, [P1])
    assert list(ja.new_tokens) == ref[0][:18]
    # while a job waits for a slot, the next power of two of the smallest budget
    gen.pending = [Job(np.asarray(P2))]
    for left, n in ((1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (30, 8)):
        job = Job(np.asarray(P1), max_new_tokens=40)
        job.new_tokens = [7] * (40 - left)
        assert gen._burst_n([job]) == n
    gen.pending = []
    assert gen._burst_n([job]) == 8
    # one slot, three jobs: each burst ends where the running job does
    single, _ = _run(pm, 1, [P1, P2, P1[:17]], max_new=11, max_batch_size=1)
    burst, gen = _run(pm, 8, [P1, P2, P1[:17]], max_new=11, max_batch_size=1)
    assert burst == single
    assert gen.decoder.steps == 8 + 4 + 8 + 4 + 8 + 8  # nothing waits behind the last job


def test_padded_rows_leave_real_rows_alone(models):
    """Three rows in bucket 4 (the fourth padded: token 0, scratch page 0,
    length 0; `pad` pads the eager step as a captured one is) give the
    logits the unpadded three-row step gives."""
    _, pm = models
    cache = Cache(pm, CacheSpec(num_pages=8))
    rng = np.random.default_rng(1)
    lens = (40, 300, 17)
    pages = [[1], [2, 3], [4]]
    ids = []
    for n, pg in zip(lens, pages):
        seq = rng.integers(0, 512, n + 1)
        ids.append(int(seq[-1]))
        pm.forward(seq[None, :n], cache, np.arange(n, dtype=np.int32)[None],
                   np.array([0], np.int32), np.array([pg + [0]], np.int32))
    counts = torch.zeros((5, 512), dtype=torch.int32)
    step = dg.DecodeGraph(pm, cache, counts, torch.Generator().manual_seed(0), max_batch_size=4,
                          n_max=1, capture=False, keep_logits=True, pad=True)
    toks = step.run(ids, list(lens), pages, [0, 1, 2], [GreedySampler()] * 3, 1)
    s = step.last
    assert (s.B, s.MP) == (4, 2) and s.d["slots"].tolist() == [0, 1, 2, 4]
    bt = np.array([p + [0] * (3 - len(p)) for p in pages], np.int32)
    ref = pm.forward(np.array(ids)[:, None], cache, np.array(lens, np.int32)[:, None],
                     np.array(lens, np.int32), bt)[:, -1]
    assert torch.equal(s.logits[:3], ref)
    assert toks[0].tolist() == ref.argmax(-1).tolist()
    assert int(counts[4].sum()) == 0 and int(counts[:3].sum()) == 3  # a padded row counts nothing


class _FakeGraph:
    """Stands in for a captured graph on the CPU: a replay runs the step."""

    def __init__(self, step, s):
        self.replay = lambda: step._step(s)


def _fake_capture(step, monkeypatch, counts=None) -> list:
    """Make `step` capture as on the card, with the capture faked; returns
    the batch bucket of each capture."""
    captured = []

    def capture(s):
        captured.append(s.B)
        s.graph, s.counts = _FakeGraph(step, s), dict(counts or {})
    step.capture = True
    monkeypatch.setattr(step, "_capture", capture)
    return captured


def test_only_captured_steps_pad(models, monkeypatch):
    """A model's graph_decode_rows caps the buckets that are captured: a
    step of up to that many rows is padded to its bucket, captured after its
    warm-up and replayed; a wider one runs eagerly every step at its exact
    rows and table width, as without graphs."""
    _, pm = models
    step = dg.DecodeGraph(pm, Cache(pm, CacheSpec(num_pages=12)), torch.zeros((17, 512),
                          dtype=torch.int32), torch.Generator(), max_batch_size=16, n_max=4,
                          capture=False, max_rows=8)
    captured = _fake_capture(step, monkeypatch)
    shapes = []
    run_step = step._step
    monkeypatch.setattr(step, "_step", lambda s: (shapes.append((s.B, s.MP)), run_step(s)))
    for rows in (3, 8, 9, 16):
        pages = [[1 + (i + k) % 11 for k in range(3)] for i in range(rows)]
        step.run([5] * rows, [3] * rows, pages, list(range(rows)), [GreedySampler()] * rows, 2)
    assert captured == [4, 8]
    assert {key: s.graph is not None for key, s in step.buckets.items()} == {
        (4, 4): True, (8, 4): True}
    # two steps each: the warm-up and a replay of the captured buckets, then
    # the exact shapes of 9 and 16 rows over 3 pages
    assert shapes == [(4, 4), (4, 4), (8, 4), (8, 4), (9, 3), (9, 3), (16, 3), (16, 3)]
    assert step.steps == 8


@pytest.mark.parametrize("steps", [1, 4])
def test_replay_adds_the_captured_counts(models, monkeypatch, steps):
    """A replay runs no Python: each adds the launches the capture counted.
    A fake graph stands in for the captured one on the CPU."""
    _, pm = models
    step = dg.DecodeGraph(pm, Cache(pm, CacheSpec(num_pages=4)), torch.zeros((3, 512),
                          dtype=torch.int32), torch.Generator(), max_batch_size=2, n_max=4,
                          capture=False)
    replays = []
    _fake_capture(step, monkeypatch, {"int8_matmul": 7, "fused_mlp": 2})
    saved = launches.read_counts()
    step.run([5], [3], [[1]], [0], [GreedySampler()], 1)  # the warm-up, then the capture
    assert launches.read_counts() == saved  # CPU tensors launch no kernel
    bucket = step.buckets[(1, 1)]
    replay = bucket.graph.replay
    bucket.graph.replay = lambda: (replays.append(1), replay())
    try:
        step.run([5], [3], [[1]], [0], [GreedySampler()], steps)
        got = launches.counts_since(saved)
    finally:
        launches.set_counts(saved)
    assert len(replays) == steps and step.steps == 1 + steps
    assert got == {"int8_matmul": 7 * steps, "fused_mlp": 2 * steps}


def test_growth_after_capture_keeps_the_captured_workspace():
    """A graph captured over the scratch buffer and the arrival counters
    holds them: a later call that grows either takes a new buffer, and the
    held one stays alive (its memory is not handed to another tensor)."""
    dev = torch.device("cpu")
    saved = dict(udev._SCRATCH), dict(udev._COUNTERS)
    try:
        udev._SCRATCH.pop(dev, None)
        udev._COUNTERS.pop(dev, None)
        s0, c0 = udev.scratch(dev, 1000), udev.arrival_counters(dev, 10)
        held = udev.workspace_buffers()  # what DecodeGraph keeps at a capture
        assert any(t is s0 for t in held) and any(t is c0 for t in held)
        ws, wc = weakref.ref(s0), weakref.ref(c0)
        ptrs = (s0.data_ptr(), c0.data_ptr())
        del s0, c0
        s1, c1 = udev.scratch(dev, 4 << 20), udev.arrival_counters(dev, 5000)
        gc.collect()
        assert ws() is not None and wc() is not None
        assert (ws().data_ptr(), wc().data_ptr()) == ptrs
        assert s1.data_ptr() != ptrs[0] and c1.data_ptr() != ptrs[1]
        del held
        gc.collect()
        assert ws() is None and wc() is None  # nothing else held them
    finally:
        udev._SCRATCH.clear()
        udev._SCRATCH.update(saved[0])
        udev._COUNTERS.clear()
        udev._COUNTERS.update(saved[1])


def _family_configs() -> dict:
    """config.json of each family, by the class it builds (Llama, Mistral
    and Qwen2 build LlamaModel)."""
    moe = synth.tiny_moe_cfg()
    return {"LlamaModel": synth.tiny_llama_cfg(),
            "Qwen3Model": synth.tiny_llama_cfg(arch="Qwen3ForCausalLM"),
            "Gemma3Model": synth.gemma3_27b_cfg(num_hidden_layers=2),
            "Qwen3MoeModel": moe,
            "MixtralModel": synth.tiny_moe_cfg(arch="MixtralForCausalLM"),
            # top 4 of 8: the block-sparse MLP never takes the grouped path
            "Qwen3MoeModel, top 4 of 8": dict(moe, num_experts_per_tok=4),
            "DeepseekV2Model": synth.deepseek_v2_lite_cfg(num_hidden_layers=2),
            "DeepseekV4Model": synth.deepseek_v4_cfg(num_hidden_layers=2)}


def test_which_families_capture_their_decode_step(models, tmp_path):
    """Graph decode where no module reads the device on the host during a
    decode step (Model.graph_decode_rows, the least its modules allow): the
    Llama family and Gemma at any batch, the MoE families and DeepSeek V2
    below 16 rows (from 16 the block-sparse MLP's grouped path reads its
    group sizes on the host, where top-k leaves it a path); DeepSeek-V4 (a
    nonzero in its attention) runs its bursts eagerly. On the CPU nothing is
    captured."""
    from exllamav3_tpu_torch.model.model import _as_tensor

    table = {}
    for name, cfg in _family_configs().items():
        d = tmp_path / name.replace(" ", "_").replace(",", "")
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        m = Model.from_config(Config.from_directory(str(d)), device="cpu")
        assert type(m).__name__ == name.split(",")[0]
        table[name] = m.graph_decode_rows
    assert table == {"LlamaModel": None, "Qwen3Model": None, "Gemma3Model": None,
                     "Qwen3MoeModel": 15, "MixtralModel": 15, "Qwen3MoeModel, top 4 of 8": None,
                     "DeepseekV2Model": 15, "DeepseekV4Model": 0}
    _, pm = models
    gen = Generator(pm, Cache(pm, CacheSpec(num_pages=4)))
    assert not gen.decoder.capture and gen.decode_burst == 8 and gen.prefill_burst == 4
    with pytest.raises(ValueError, match="capture needs a CUDA model"):
        dg.DecodeGraph(pm, gen.cache, gen.token_counts, gen.rng, 4, 8, capture=True)
    # a captured step hands its static tensors to Model.forward, which takes
    # them as they are
    t = torch.zeros(3, dtype=torch.int32)
    assert _as_tensor(t, torch.device("cpu")) is t


def test_wide_moe_batch_keeps_the_selected_expert_route(tmp_path, monkeypatch):
    """The generator's decoder over a Qwen3-MoE model, capturing as on the
    card (faked): 4 rows pad to bucket 4 and are captured; 12 rows (bucket
    16, above the model's 15) run eagerly at 12 rows, so that the
    block-sparse MLP takes the selected-expert route (on the card the
    moe_gemm kernel), not the grouped one; 16 rows take the grouped route."""
    monkeypatch.setenv("EXL3_TPU_MOE", "auto")
    d = synth.write_tiny_moe_exl3(str(tmp_path / "moe"), seed=3)
    pm = Model.from_config(Config.from_directory(d), device="cpu")
    pm.load()
    gen = Generator(pm, Cache(pm, CacheSpec(num_pages=20)), max_batch_size=16, decode_burst=2)
    step = gen.decoder
    assert step.max_rows == 15
    captured = _fake_capture(step, monkeypatch)
    routes = []
    for route in ("_selected_experts", "_grouped_experts"):
        orig = getattr(BlockSparseMLP, route)
        monkeypatch.setattr(BlockSparseMLP, route,
                            lambda self, xt, *a, _o=orig, _r=route: (
                                routes.append((_r, xt.shape[0])), _o(self, xt, *a))[1])
    for rows in (4, 12, 16):
        routes.clear()
        step.run([5] * rows, [0] * rows, [[1 + i] for i in range(rows)], list(range(rows)),
                 [GreedySampler()] * rows, 1)
        layers = pm.config.num_hidden_layers
        want = ("_grouped_experts" if rows == 16 else "_selected_experts",
                rows if rows > 4 else 4)
        assert routes == [want] * layers, rows
        assert step.last.B == want[1]
    assert captured == [4]
