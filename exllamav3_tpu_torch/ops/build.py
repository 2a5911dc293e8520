"""Build and load the port's CUDA kernels.

The sources under exllamav3_tpu_torch/csrc/ have a plain C interface. At
first use each source compiles with its own `nvcc` process, all started
together, and the objects link into one shared library loaded with ctypes.
The library lands in <repo>/build/exllamav3_tpu_torch/, named by a digest of
the sources and flags, so a changed source rebuilds and an unchanged one is
reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "exllamav3_tpu_torch"
SOURCES = ("int8_matmul.cu", "fused_mlp.cu", "paged_attention.cu", "exl3_gemm.cu",
           "paged_attention_quant.cu", "int4_matmul.cu", "intb_matmul.cu", "moe_gemm.cu",
           "linear_attention.cu", "linear_attention_quant.cu", "latent_attention.cu",
           "latent_attention_quant.cu", "ring_attention.cu", "attention_stats.cu",
           "probe_dma.cu", "probe_trellis.cu", "probe_kv_dequant.cu", "probe_int4.cu")
HEADERS = ("packed_matmul.cuh", "attention_tiles.cuh", "attention_decode.cuh",
           "async_copy.cuh", "intb_layout.cuh", "int4_layout.cuh", "latent_decode.cuh",
           "int8_layout.cuh", "int8_staged.cuh", "attention_prefill.cuh",
           "latent_prefill.cuh")  # included by sources; part of the digest
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p; all return an int,
# the launch's cudaGetLastError() where the entry launches a kernel
SIGNATURES = {
    "exl3_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "exl3_fused_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "exl3_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _F, _I, _P],
    "exl3_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "exl3_paged_attention_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _F, _I, _P],
    "exl3_int4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "exl3_int4_matmul_a8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "exl3_intb_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "exl3_intb_matmul_a8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "exl3_moe_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "exl3_linear_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _F, _I, _F, _I, _P],
    "exl3_linear_attention_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _F, _I, _P],
    "exl3_latent_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _I, _P],
    "exl3_latent_attention_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _F, _F, _F, _I, _P],
    "exl3_ring_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                            _I, _F, _I, _P],
    "exl3_ring_attention_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                  _I, _P],
    "exl3_pool_attention_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _P],
    "exl3_rows_attention_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # the measurement probes (probes/)
    "exl3_probe_dma": [_P, _P, _P, _I, _I, _I, _P],
    "exl3_probe_trellis": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "exl3_probe_kv_dequant": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "exl3_probe_int4_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "exl3_probe_a8_ablate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "exl3_probe_a8_diag": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # the split-key decode kernel's launches so far (csrc/attention_decode.cuh),
    # which tell a check the kernel an attention entry chose
    "exl3_decode_launches": [],
    # the bf16 prefill body's launches so far (csrc/attention_prefill.cuh),
    # which tell a check that a paged or linear bf16 chunk took it
    "exl3_prefill_launches": [],
    # the trellis GEMM's kernel launches so far, and the blocks an SM holds of
    # the kernel a product of these widths launches (csrc/exl3_gemm.cu)
    "exl3_gemm_launches": [],
    "exl3_gemm_blocks_per_sm": [_I, _I, _I, _I, _I, _I],
    # the int-B library's launches so far by kernel (0 products, 1 row
    # quantizers, 2 split-k reduces), and the blocks an SM holds of the staged
    # body a product of these widths launches (csrc/intb_matmul.cu)
    "exl3_intb_launches": [_I],
    "exl3_intb_blocks_per_sm": [_I, _I, _I, _I, _I, _I],
    # the int4 library's launches so far by kernel (0 packed_matmul.cuh's
    # products, 1 row quantizers, 2 split-k reduces, 3 staged products), and
    # the blocks an SM holds of the staged body a product of these widths
    # launches on either route (csrc/int4_matmul.cu)
    "exl3_int4_launches": [_I],
    "exl3_int4_blocks_per_sm": [_I, _I, _I, _I, _I],
    # the int8 library's launches so far by kernel (0 staged products, 1 tiled
    # products, 2 split-k reduces), the blocks an SM holds of the staged body a
    # product of these widths launches (csrc/int8_matmul.cu), and the fused
    # MLP's launches by phase (csrc/fused_mlp.cu)
    "exl3_int8_launches": [_I],
    "exl3_int8_blocks_per_sm": [_I, _I, _I, _I],
    "exl3_fused_mlp_launches": [_I],
    # the latent split-key decode kernel's launches so far (csrc/latent_decode.cuh:
    # the latent entries' decode and the three stats entries), and the tile
    # loop's (csrc/attention_tiles.cuh: the ring's groups of more than 32 heads)
    "exl3_latent_decode_launches": [],
    "exl3_tile_launches": [],
    # the latent prefill body's launches so far, and those of its pre-pass,
    # which lays the keys out as the body's tiles (csrc/latent_prefill.cuh)
    "exl3_latent_prefill_launches": [],
    "exl3_latent_tiles_launches": [],
}

_LIB = None
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the kernel library.
    BUILD_LOG receives the seconds taken and each compiler's output."""
    lib_path = BUILD_DIR / f"libexl3_kernels_{_digest()}.so"
    if lib_path.exists():
        BUILD_LOG.update(seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, failed = [], []
        for name, obj, proc in procs:
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", *objs, "-o", tmp_lib],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, lib_path)
    BUILD_LOG.update(seconds=time.time() - t0, cached=False)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def header_constants(header: str, *names: str) -> tuple[int, ...]:
    """The values of the `constexpr int NAME = value;` lines of a header in
    csrc/, for host code that must agree with a kernel's limits. Raises
    unless each name is defined once."""
    src = (CSRC_DIR / header).read_text()
    values = []
    for name in names:
        found = re.findall(rf"^constexpr int {name} = (\d+);", src, re.M)
        if len(found) != 1:
            raise RuntimeError(f"{header}: constexpr int {name} is defined {len(found)} times")
        values.append(int(found[0]))
    return tuple(values)


def check_aligned(fn_name: str, *tensors) -> None:
    """The kernels read 16-byte vectors: every base pointer must be aligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{fn_name}: tensor data must be 16-byte aligned")


def check_launch(fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
