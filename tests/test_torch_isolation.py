"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "exllamav3_tpu_torch")


def _port_files():
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")
    for tool in ("torch_attention_ab.py", "torch_decode_phases.py", "torch_packed_phases.py"):
        yield os.path.join(ROOT, "tools", tool)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "exllamav3_tpu")


def test_no_jax_imports_in_port_sources():
    files = list(_port_files())
    assert len(files) > 20
    scanned = {os.path.relpath(f, ROOT) for f in files}
    assert {"exllamav3_tpu_torch/ops/exl3_gemm.py", "exllamav3_tpu_torch/ops/kv_quant.py",
            "exllamav3_tpu_torch/ops/flash_attention.py", "exllamav3_tpu_torch/model/cache.py",
            "exllamav3_tpu_torch/util/params.py", "exllamav3_tpu_torch/ops/q_matmul.py",
            "exllamav3_tpu_torch/util/env.py", "exllamav3_tpu_torch/modules/multilinear.py",
            "exllamav3_tpu_torch/ops/moe_gemm.py", "exllamav3_tpu_torch/modules/block_sparse_mlp.py",
            "exllamav3_tpu_torch/architectures/moe.py", "exllamav3_tpu_torch/generator/ngram.py",
            "exllamav3_tpu_torch/generator/generator.py", "exllamav3_tpu_torch/modules/attn.py",
            "exllamav3_tpu_torch/modules/mla_attn.py", "exllamav3_tpu_torch/architectures/deepseek.py",
            "exllamav3_tpu_torch/util/rope.py", "exllamav3_tpu_torch/conversion/synth.py",
            "exllamav3_tpu_torch/architectures/gemma.py", "chip_smoke.py",
            "exllamav3_tpu_torch/modules/dsv4_attn.py",
            "exllamav3_tpu_torch/modules/hyperconnections.py",
            "exllamav3_tpu_torch/architectures/deepseek_v4.py",
            "tools/torch_attention_ab.py", "tools/torch_decode_phases.py",
            "tools/torch_packed_phases.py", "exllamav3_tpu_torch/util/timing.py",
            *(f"exllamav3_tpu_torch/probes/{name}.py" for name in
              ("__init__", "fused_ablate", "dequant_probe", "int4_sweep", "a8_ablate",
               "a8_diag_proto", "dma_floor"))} <= scanned
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
                names = [a.value for a in node.args if isinstance(a, ast.Constant)]
            for name in names:
                assert not _forbidden(name), f"{os.path.relpath(path, ROOT)} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import exllamav3_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'exllamav3_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_packed_modules_import_without_triton_or_a_built_library():
    """The packed-integer ops and the environment readers import on a machine
    with no compiler: nothing builds or loads a kernel library at import, and
    neither triton nor jax comes in."""
    code = (
        "import sys\n"
        "import exllamav3_tpu_torch.util.env as env\n"
        "import exllamav3_tpu_torch.ops.q_matmul as qm\n"
        "import exllamav3_tpu_torch.ops.moe_gemm as moe\n"
        "import exllamav3_tpu_torch.ops.build as build\n"
        "assert build._LIB is None and not build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exllamav3_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert {'int4_matmul.cu', 'intb_matmul.cu', 'moe_gemm.cu'} <= set(build.SOURCES)\n"
        "assert hasattr(moe, 'selected_expert_mlp_kernel') and hasattr(moe, 'selected_expert_mlp_plain')\n"
        "assert all(hasattr(qm, n + '_kernel') and hasattr(qm, n + '_plain') for n in "
        "('int4_matmul', 'int4_matmul_a8', 'intb_matmul', 'intb_matmul_a8'))\n"
        "assert sorted(n for n in dir(env) if n.startswith('env_')) == "
        "['env_bool', 'env_int', 'env_str'] and callable(env.moe_backend)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_without_cuda(tmp_path, monkeypatch):
    """Without CUDA an entry point called without device="cpu" raises; it
    runs on the CPU only when asked to."""
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
    from exllamav3_tpu_torch.model import Config, Model
    from exllamav3_tpu_torch.util.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = write_tiny_llama_exl3(str(tmp_path / "m"), tiny_llama_cfg(num_layers=1), seed=2)
    config = Config.from_directory(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.from_config(config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    model = Model.from_config(config, device="cpu")
    model.load()
    assert model.forward_simple([[1, 2, 3]]).shape == (1, 3, 512)


def test_capacity_configuration_follows_the_model_device(tmp_path, monkeypatch):
    """`fused` linears and a quantized cache land on the model's device: the
    card by default (refused without CUDA), the CPU only when asked."""
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
    from exllamav3_tpu_torch.generator import Generator
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = write_tiny_llama_exl3(str(tmp_path / "m"), tiny_llama_cfg(num_layers=1), seed=2)
    config = Config.from_directory(d, infer_params=InferParams(linear_mode="fused"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.from_config(config)
    model = Model.from_config(config, device="cpu")
    model.load()
    cache = Cache(model, CacheSpec(num_pages=3, k_bits=4, v_bits=4))
    layer = cache.state[cache.layer_keys[0]]
    assert set(layer) == {"k_q", "k_s", "v_q", "v_s"}
    assert all(t.device.type == "cpu" for t in layer.values())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cache(model, CacheSpec(num_pages=3, k_bits=4, v_bits=4), device="cuda")
    assert Generator(model, cache).device.type == "cpu"


def test_speculative_modules_import_without_a_built_library():
    """The linear attention wrappers, the suffix automaton and the speculative
    generator import on a machine with no compiler: nothing builds or loads a
    kernel library, and neither triton nor jax comes in."""
    code = (
        "import sys\n"
        "import exllamav3_tpu_torch.generator.ngram as ngram\n"
        "import exllamav3_tpu_torch.generator.generator as gen\n"
        "import exllamav3_tpu_torch.ops.flash_attention as fa\n"
        "import exllamav3_tpu_torch.ops.build as build\n"
        "assert build._LIB is None and not build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exllamav3_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert {'linear_attention.cu', 'linear_attention_quant.cu'} <= set(build.SOURCES)\n"
        "assert 'attention_tiles.cuh' in build.HEADERS\n"
        "assert all(hasattr(fa, 'linear_attention' + s + '_' + r) for s in ('', '_quant') "
        "for r in ('kernel', 'plain'))\n"
        "assert callable(ngram.SuffixAutomaton) and callable(gen.Generator._decode_batch_sd)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_linear_cache_and_draft_follow_the_model_device(tmp_path, monkeypatch):
    """A linear cache and the draft model's cache land on the model's device:
    the card by default (refused without CUDA), the CPU only when asked; the
    linear kernels refuse CPU tensors rather than run their plain versions."""
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
    from exllamav3_tpu_torch.generator import Generator
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, Model
    from exllamav3_tpu_torch.ops.flash_attention import linear_attention_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = write_tiny_llama_exl3(str(tmp_path / "m"), tiny_llama_cfg(num_layers=1), seed=2)
    model = Model.from_config(Config.from_directory(d), device="cpu")
    model.load()
    spec = CacheSpec(layout="linear", batch_size=2, max_len=32, k_bits=4, v_bits=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cache(model, spec, device="cuda")
    cache = Cache(model, spec)
    layer = cache.state[cache.layer_keys[0]]
    assert all(t.device.type == "cpu" and t.shape[:2] == (2, 32) for t in layer.values())
    gen = Generator(model, Cache(model, CacheSpec(num_pages=4)), max_batch_size=2,
                    draft_model=model)
    assert gen.draft_cache.device.type == "cpu"
    assert len(gen.generate(np.arange(3, 9), max_new_tokens=4)) == 4 and gen.num_drafted > 0
    x = torch.zeros((1, 1, 4, 64))
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    pos = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        linear_attention_kernel(x, kv, kv, pos, torch.ones(1, dtype=torch.int32))


def test_mla_modules_import_without_a_built_library():
    """The MLA module, the DeepSeek architectures and the latent attention
    wrappers import on a machine with no compiler: nothing builds or loads a
    kernel library, and neither triton nor jax comes in."""
    code = (
        "import sys\n"
        "import exllamav3_tpu_torch.modules.mla_attn as mla\n"
        "import exllamav3_tpu_torch.architectures.deepseek as ds\n"
        "import exllamav3_tpu_torch.ops.flash_attention as fa\n"
        "import exllamav3_tpu_torch.ops.build as build\n"
        "from exllamav3_tpu_torch.architectures import get_architectures\n"
        "assert build._LIB is None and not build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exllamav3_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert {'latent_attention.cu', 'latent_attention_quant.cu'} <= set(build.SOURCES)\n"
        "assert all(hasattr(fa, 'latent_attention' + s + '_' + r) for s in ('', '_quant') "
        "for r in ('kernel', 'plain')) and callable(fa.latent_attention_any)\n"
        "assert {'DeepseekV3ForCausalLM', 'DeepseekV2ForCausalLM', 'DeepseekForCausalLM'} "
        "<= set(get_architectures())\n"
        "assert callable(mla.MLAttention) and callable(ds.DeepseekV2Model)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("k_bits", [0, 4])
def test_latent_cache_follows_the_model_device(tmp_path, monkeypatch, k_bits):
    """A DeepSeek model's latent cache lands on the model's device: the card
    by default (refused without CUDA), the CPU only when asked; the latent
    kernels refuse CPU tensors rather than run their plain versions."""
    from exllamav3_tpu_torch.conversion.synth import write_tiny_deepseek_exl3
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, Model
    from exllamav3_tpu_torch.ops.flash_attention import (latent_attention_kernel,
                                                          latent_attention_quant_kernel)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = write_tiny_deepseek_exl3(str(tmp_path / "ds"), seed=2)
    config = Config.from_directory(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.from_config(config)
    model = Model.from_config(config, device="cpu")
    spec = CacheSpec(num_pages=3, k_bits=k_bits, v_bits=k_bits)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cache(model, spec, device="cuda")
    layer = Cache(model, spec).state["model.layers.0.self_attn"]
    names = {"kv_q", "kv_s", "k_pe"} if k_bits else {"kv"}
    assert set(layer) == names and all(t.device.type == "cpu" for t in layer.values())
    q = torch.zeros((1, 1, 16, 576), dtype=torch.bfloat16)
    pos = torch.zeros((1, 1), dtype=torch.int32)
    bt = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        if k_bits:
            state = {"kv_q": torch.zeros((2, 256, 1, 64), dtype=torch.int32),
                     "kv_s": torch.zeros((2, 256, 1, 16), dtype=torch.bfloat16),
                     "k_pe": torch.zeros((2, 256, 1, 64), dtype=torch.bfloat16)}
            latent_attention_quant_kernel(q, state, pos, torch.ones(1, dtype=torch.int32), 4,
                                          block_tables=bt)
        else:
            kv = torch.zeros((2, 256, 1, 576), dtype=torch.bfloat16)
            latent_attention_kernel(q, kv, pos, torch.ones(1, dtype=torch.int32), block_tables=bt)


def test_ring_modules_import_without_a_built_library():
    """The ring attention wrappers, the Gemma architectures and the fused MLP
    with its activations import on a machine with no compiler: nothing builds
    or loads a kernel library, and neither triton nor jax comes in."""
    code = (
        "import sys\n"
        "import exllamav3_tpu_torch.architectures.gemma as gemma\n"
        "import exllamav3_tpu_torch.ops.flash_attention as fa\n"
        "import exllamav3_tpu_torch.ops.fused_mlp as fm\n"
        "import exllamav3_tpu_torch.ops.build as build\n"
        "assert build._LIB is None and not build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exllamav3_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert 'ring_attention.cu' in build.SOURCES\n"
        "assert all(hasattr(fa, 'ring_attention' + s) for s in ('', '_kernel', '_plain'))\n"
        "assert set(fm.ACTIVATIONS) == {'silu', 'gelu', 'gelu_pytorch_tanh', 'relu2'}\n"
        "assert callable(gemma.Gemma2Config) and callable(gemma.Gemma3Config)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_ring_kernel_refuses_cpu_tensors_and_prefill():
    """The ring kernel's wrapper never runs its plain version: CPU tensors
    and chunks of more than one query are refused before any launch."""
    from exllamav3_tpu_torch.ops.flash_attention import ring_attention_kernel
    from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8_kernel

    q = torch.zeros((1, 1, 4, 64))
    ring = torch.zeros((2, 24, 2, 64), dtype=torch.bfloat16)
    pos = torch.full((2, 24), -1, dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ring_attention_kernel(q, ring, ring, pos, one, one[:, None])
    with pytest.raises(ValueError, match="activation"):
        fused_mlp_int8_kernel(torch.zeros((1, 256), dtype=torch.bfloat16),
                              torch.zeros((256, 256), dtype=torch.int8), torch.ones(256),
                              torch.zeros((128, 256), dtype=torch.int8), activation="xielu")


def test_dsv4_modules_import_without_a_built_library():
    """DeepSeek-V4's modules, its architecture and the row 6b wrappers import
    on a machine with no compiler: nothing builds or loads a kernel library,
    and neither triton nor jax comes in."""
    code = (
        "import sys\n"
        "import exllamav3_tpu_torch.architectures.deepseek_v4 as v4\n"
        "import exllamav3_tpu_torch.modules.dsv4_attn as dsv4\n"
        "import exllamav3_tpu_torch.modules.hyperconnections as hc\n"
        "import exllamav3_tpu_torch.ops.flash_attention as fa\n"
        "import exllamav3_tpu_torch.ops.build as build\n"
        "from exllamav3_tpu_torch.architectures import get_architectures\n"
        "assert build._LIB is None and not build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exllamav3_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert 'attention_stats.cu' in build.SOURCES\n"
        "assert all(hasattr(fa, n + '_attention_stats' + s) for n in ('ring', 'pool', 'rows') "
        "for s in ('', '_kernel', '_plain')) and callable(fa.merge_stats)\n"
        "assert 'DeepseekV4ForCausalLM' in get_architectures()\n"
        "assert dsv4.DSV4Attention.is_recurrent and callable(hc.HyperConnection)\n"
        "assert callable(v4.DeepseekV4Model)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_dsv4_cache_follows_the_model_device(tmp_path, monkeypatch):
    """A DeepSeek-V4 model and its cache (rings, compressor buffers, paged
    pools) land on the model's device: the card by default (refused without
    CUDA), the CPU only when asked."""
    from exllamav3_tpu_torch.conversion.synth import write_tiny_deepseek_v4_exl3
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = Config.from_directory(write_tiny_deepseek_v4_exl3(str(tmp_path / "v4"), seed=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.from_config(config)
    model = Model.from_config(config, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cache(model, CacheSpec(num_pages=3), device="cuda")
    state = Cache(model, CacheSpec(num_pages=3, recurrent_slots=5)).state
    assert set(state["layers.0.attn"]) == {"kv", "pos"}
    assert set(state["layers.1.attn"]) == {"kv", "pos", "pg_pool", "cb_kv", "cb_gate", "pg_ipool",
                                           "icb_kv", "icb_gate"}
    assert state["layers.2.attn"]["pg_pool"].shape == (3, 256 // 8, 32)
    assert state["layers.1.attn"]["kv"].shape == (5, 8 + 16, 32)
    assert all(t.device.type == "cpu" for layer in state.values() for t in layer.values())


def test_probe_modules_import_without_a_built_library():
    """The six probes import on a machine with no compiler: nothing builds or
    loads a kernel library, and neither triton nor jax comes in; each has a
    plain version, a kernel wrapper that counts its launches, a dispatcher
    and main(), and its four sources are in the build."""
    code = (
        "import sys\n"
        "import exllamav3_tpu_torch.ops.build as build\n"
        "from exllamav3_tpu_torch.probes import (fused_ablate, dequant_probe, int4_sweep, "
        "a8_ablate, a8_diag_proto, dma_floor)\n"
        "assert build._LIB is None and not build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exllamav3_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert {'probe_dma.cu', 'probe_trellis.cu', 'probe_kv_dequant.cu', 'probe_int4.cu'} "
        "<= set(build.SOURCES)\n"
        "mods = {fused_ablate: 'fused_ablate', dequant_probe: 'dequant_probe', "
        "int4_sweep: 'int4_sweep', a8_ablate: 'a8_ablate', a8_diag_proto: 'a8_diag', "
        "dma_floor: 'dma_floor'}\n"
        "for m, n in mods.items():\n"
        "    assert callable(m.main) and callable(getattr(m, n + '_plain'))\n"
        "    assert getattr(m, n + '_kernel').launches == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
