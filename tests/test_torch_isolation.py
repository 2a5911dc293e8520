"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

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
            "exllamav3_tpu_torch/architectures/moe.py", "chip_smoke.py"} <= scanned
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
