"""Quantized-weight matmuls of the materialized linear modes
(counterpart of exllamav3_tpu/ops/q_matmul.py).

  * int8: y = (x @ W_q) * scale[col], 1 byte a weight (csrc/int8_matmul.cu);
  * int4: grouped 4-bit codes, two a byte along k, one bf16 scale per 32 rows
    and column: 0.5625 bytes a weight (csrc/int4_matmul.cu);
  * int-B (B = 3, 4, 5, 6): 32 // B codes in an int32 word, plane-major along
    k, the same group scales (csrc/intb_matmul.cu). B = 4 in this layout
    holds the conversion-time `.sq` tensors only; the load-time int4 tier
    keeps its byte pairs.

Each packed tier has two kernels. The bf16 kernel multiplies bf16 x by
bf16(code * scale), one rounding per weight. The a8 kernel quantizes each row
of x to int8 (scale max|x|/127 + 1e-12, round half to even, a true division),
takes an exact int32 dot per 32-row group, and applies the group scale and
the row scale in f32. EXL3TPU_INT4_A8 / EXL3TPU_INTB_A8 choose: a8 unless set
to 0. Unlike the JAX package, whose CPU default is its reference product, the
port's default is a8 on the CPU too, so that the card and the CPU compute the
same function.

The packed layouts are the JAX package's, so a parameter dict carries across
unchanged. On a CUDA tensor every wrapper launches its hand-written kernel or
raises; on a CPU tensor the dispatchers run the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..util.env import env_bool
from .build import check_aligned, check_launch, library

SMALL_M = 16  # rows up to this take the decode tiling (16 x 128 x 128)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (m, k); w_q (k, n) int8; scale (n,) f32 -> (m, n) f32: bf16 x,
    bf16-exact weights, f32 accumulation."""
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return y * scale[None, :].to(torch.float32)


def _split_k(tiles: int, k_tiles: int, device) -> int:
    """Split the k loop until the grid has about two blocks per SM, keeping
    at least two k tiles per split."""
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    s = 1
    while tiles * s < target and k_tiles % (2 * s) == 0 and k_tiles // (2 * s) >= 2:
        s *= 2
    return s


def int8_matmul_kernel(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int8_matmul.cu: x (m, k) bf16, w_q (k, n) int8, scale (n,)
    f32, all contiguous on one CUDA device; k % 64 == 0, n % 64 == 0 (the
    kernel cuts its last column and k tiles at n and k)."""
    m, k = x.shape
    n = w_q.shape[1]
    if not (x.is_cuda and w_q.device == x.device and scale.device == x.device):
        raise ValueError("int8_matmul_kernel: all tensors must be on one CUDA device")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul_kernel: dtypes {x.dtype}, {w_q.dtype}, {scale.dtype}")
    if w_q.shape[0] != k or scale.shape != (n,) or k % 64 or n % 64 or m == 0:
        raise ValueError(f"int8_matmul_kernel: shapes x {tuple(x.shape)}, w {tuple(w_q.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul_kernel: tensors must be contiguous")
    check_aligned("int8_matmul_kernel", x, w_q, scale)
    bm, bk = (16, 128) if m <= SMALL_M else (128, 32)
    # k splits only into whole k tiles
    splits = _split_k(-(-n // 128) * -(-m // bm), k // bk if k % bk == 0 else 1, x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else y
    err = library().exl3_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), ws.data_ptr(),
        m, k, n, splits, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("exl3_int8_matmul", err)
    int8_matmul_kernel.launches += 1
    return y


int8_matmul_kernel.launches = 0


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias=None) -> torch.Tensor:
    """x (..., k) -> (..., n) f32. CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    shape = x.shape
    n = w_q.shape[1]
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        y = int8_matmul_plain(x2, w_q, scale)
    else:
        y = int8_matmul_kernel(x2.to(torch.bfloat16).contiguous(), w_q, scale)
    if bias is not None:
        y = y + bias
    return y.reshape(*shape[:-1], n)


# -- packing: grouped int4 (byte pairs) and int-B (planes in int32 words) ------

INT4_GROUP = 32
INT4_LLOYD_ITERS = 4
INTB_GROUP = 32
_INTB_BITS = (3, 4, 5, 6)


def _lloyd_codes(wf: torch.Tensor, lo: int, hi: int, group: int):
    """f32 (k, n), k % group == 0 -> (codes (k, n) int64 in [lo, hi], scales
    (k/group, n) f32). The JAX package's alternation: round at the current
    scale, then the least-squares scale for that rounding."""
    k, n = wf.shape
    wr = wf.reshape(k // group, group, n)
    scale = wr.abs().amax(dim=1) / float(hi) + 1e-12
    for _ in range(INT4_LLOYD_ITERS):
        qr = torch.clamp(torch.round(wr / scale[:, None, :]), lo, hi)
        num = (wr * qr).sum(dim=1)
        den = (qr * qr).sum(dim=1) + 1e-12
        scale = torch.clamp_min(num / den, 1e-12)
    q = torch.clamp(torch.round(wr / scale[:, None, :]), lo, hi)
    return q.reshape(k, n).to(torch.int64), scale


def _wrap(v: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    """Unsigned `bits`-bit patterns in int64 -> the signed dtype of that width."""
    half = 1 << (bits - 1)
    return ((v ^ half) - half).to(dtype)


def int4_pack(w: torch.Tensor, group: int = INT4_GROUP):
    """f32 (k, n) -> (packed (k/2, n) int8, scales (k/group, n) bf16), on w's
    device. Byte r of a column holds weight row r in its low nibble and row
    r + k/2 in its high nibble, both biased by +8. k % (2 * group) == 0."""
    k, n = w.shape
    if k % (2 * group):
        raise ValueError(f"int4_pack: k = {k} is no multiple of {2 * group}")
    q, scale = _lloyd_codes(w.to(torch.float32), -8, 7, group)
    packed = ((q[k // 2:] + 8) << 4) | (q[: k // 2] + 8)
    return _wrap(packed, 8, torch.int8), scale.to(torch.bfloat16)


def _int4_codes(packed: torch.Tensor) -> torch.Tensor:
    """(k/2, n) int8 -> centered codes (k, n) int32 in [-8, 7]."""
    b = packed.to(torch.int32) & 255
    return torch.cat([(b & 15) - 8, (b >> 4) - 8], dim=0)


def int4_unpack(packed: torch.Tensor, scales: torch.Tensor, group: int = INT4_GROUP):
    """(k/2, n) int8 + (k/group, n) -> the dequantized (k, n) f32 weight."""
    return (_int4_codes(packed).to(torch.float32)
            * scales.to(torch.float32).repeat_interleave(group, dim=0))


def intb_geometry(k: int, bits: int, group: int = INTB_GROUP):
    """(W codes a word, kp words per column, padded k) for a k-row column."""
    W = 32 // bits
    kp = -(-k // (W * group)) * group
    return W, kp, W * kp


def _intb_words(qb: torch.Tensor, bits: int) -> torch.Tensor:
    """Biased codes (W, kp, n) int64 in [0, 2^bits) -> words (kp, n) int32."""
    word = torch.zeros(qb.shape[1:], dtype=torch.int64, device=qb.device)
    for j in range(qb.shape[0]):
        word |= qb[j] << (bits * j)
    return _wrap(word, 32, torch.int32)


def intb_pack(w: torch.Tensor, bits: int, group: int = INTB_GROUP):
    """f32 (k, n) -> (packed (kp, n) int32, scales (W*kp/group, n) bf16), on
    w's device: weight row r is code r // kp of word r % kp; k pads with zero
    rows up to W * kp."""
    if bits not in _INTB_BITS:
        raise ValueError(f"intb_pack: bits = {bits}")
    k, n = w.shape
    W, kp, k_pad = intb_geometry(k, bits, group)
    wf = w.to(torch.float32)
    if k_pad != k:
        wf = torch.cat([wf, wf.new_zeros((k_pad - k, n))], dim=0)
    lo = -(1 << (bits - 1))
    q, scale = _lloyd_codes(wf, lo, -lo - 1, group)
    return _intb_words((q - lo).reshape(W, kp, n), bits), scale.to(torch.bfloat16)


def intb_pack_from_q_np(q, scales, bits: int, group: int = INTB_GROUP):
    """Pack given integer codes (numpy, the converter's host side): q (k, n)
    in [-2^(B-1), 2^(B-1) - 1], scales (k/group, n) f32 -> (packed (kp, n)
    int32, scales (W*kp/group, n) f32) in intb_pack's layout; pad rows hold
    code 0 and scale 1."""
    q = np.asarray(q)
    scales = np.asarray(scales, dtype=np.float32)
    k, n = q.shape
    W, kp, k_pad = intb_geometry(k, bits, group)
    if k_pad != k:
        q = np.concatenate([q, np.zeros((k_pad - k, n), q.dtype)], axis=0)
        scales = np.concatenate([scales, np.ones(((k_pad - k) // group, n), np.float32)], axis=0)
    if scales.shape[0] != k_pad // group:
        raise ValueError(f"intb_pack_from_q_np: {scales.shape[0]} scale rows for k = {k}")
    qb = torch.from_numpy(q.astype(np.int64) + (1 << (bits - 1))).reshape(W, kp, n)
    return _intb_words(qb, bits).numpy(), scales


def _intb_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(kp, n) int32 -> centered codes (W*kp, n) int32, pad rows included."""
    mask, bias = (1 << bits) - 1, 1 << (bits - 1)
    return torch.cat([((packed >> (bits * j)) & mask) - bias for j in range(32 // bits)], dim=0)


def intb_unpack(packed: torch.Tensor, scales: torch.Tensor, bits: int, k: int,
                group: int = INTB_GROUP) -> torch.Tensor:
    """The dequantized (k, n) f32 weight (drops the pad rows)."""
    _, kp, _ = intb_geometry(k, bits, group)
    if packed.shape[0] != kp:
        raise ValueError(f"intb_unpack: {packed.shape[0]} words for k = {k}, bits = {bits}")
    w = (_intb_codes(packed, bits).to(torch.float32)
         * scales.to(torch.float32).repeat_interleave(group, dim=0))
    return w[:k]


def intb_bits_from_shapes(kp: int, scale_rows: int, group: int = INTB_GROUP) -> int:
    """B from the packed and scales shapes: the scales have one row per group
    of the padded k = W * kp, so W = scale_rows * group / kp exactly."""
    W = scale_rows * group // kp
    if W * kp != scale_rows * group or W == 0 or 32 // W not in _INTB_BITS:
        raise ValueError(f"no int-B width fits {kp} words and {scale_rows} scale rows")
    return 32 // W


# -- plain products ------------------------------------------------------------

def _bf16_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x times bf16(w), f32 sums: each weight is rounded once."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def quantize_rows(x: torch.Tensor):
    """x (m, k) -> (codes (m, k) f32 in [-127, 127], scales (m, 1) f32): the a8
    kernels' row quantizer. Both divisions are tensor by tensor: a division by
    a Python number may run as a multiply by its reciprocal, which flips codes."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = amax / torch.full_like(amax, 127.0) + 1e-12
    return torch.clamp(torch.round(xf / xs), -127, 127), xs


def _a8_product(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x (m, k); centered codes (kk >= k, n) int; scales (kk/32, n) bf16.
    Per 32-row group an integer dot (exact in f32: below 2^24), times the
    group's scale, summed over the groups in f32, times the row's scale. The
    groups run in chunks so that no (groups, m, n) array is ever whole."""
    m, k = x.shape
    kk, n = codes.shape
    xq, xs = quantize_rows(x)
    if kk != k:
        xq = torch.cat([xq, xq.new_zeros((m, kk - k))], dim=1)
    groups = kk // 32
    xg = xq.reshape(m, groups, 32).transpose(0, 1)          # (groups, m, 32)
    cg = codes.reshape(groups, 32, n)
    chunk = max(1, (1 << 26) // max(m * n, 1))
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g0 in range(0, groups, chunk):
        d = torch.bmm(xg[g0: g0 + chunk], cg[g0: g0 + chunk].to(torch.float32))
        y += (d * scales[g0: g0 + chunk, None, :].to(torch.float32)).sum(dim=0)
    return y * xs


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x (m, k) times the int4 weight as bf16((nibble - 8) * scale) -> (m, n) f32."""
    return _bf16_product(x, int4_unpack(packed, scales))


def int4_matmul_a8_plain(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """x (m, k) row-quantized to int8 times the int4 codes -> (m, n) f32."""
    return _a8_product(x, _int4_codes(packed), scales)


def intb_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """x (m, k) times the int-B weight as bf16(code * scale) -> (m, n) f32."""
    return _bf16_product(x, intb_unpack(packed, scales, bits, x.shape[-1]))


def intb_matmul_a8_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """x (m, k) row-quantized to int8 times the int-B codes -> (m, n) f32."""
    return _a8_product(x, _intb_codes(packed, bits), scales)


# -- kernel wrappers -----------------------------------------------------------

# the tilings of csrc/packed_matmul.cuh: up to DECODE_ROWS rows a block covers
# 16 rows and 256 (int4) or 128 (int-B) columns, beyond that 64 rows and 128
# columns; one step of its k loop is 32 packed rows
DECODE_ROWS = 16
BLOCKS_PER_SM = 4
MIN_STEPS = 4


def _packed_splits(m: int, n: int, steps: int, nibble: bool, device) -> int:
    """k splits of a packed kernel's grid: enough blocks to fill the card at
    decode sizes, MIN_STEPS steps a split where there are that many, and no
    split left empty."""
    if m <= DECODE_ROWS:
        blocks = -(-n // (256 if nibble else 128))
    else:
        blocks = -(-n // 128) * -(-m // 64)
    target = BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(steps // MIN_STEPS, -(-target // blocks)))
    per = -(-steps // want)
    return -(-steps // per)


def _check_packed(name: str, x, packed, scales, packed_dtype, a8: bool):
    if not (x.is_cuda and packed.device == x.device and scales.device == x.device):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    x_ok = x.dtype in (torch.float32, torch.bfloat16) if a8 else x.dtype == torch.bfloat16
    if not x_ok or packed.dtype != packed_dtype or scales.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtypes {x.dtype}, {packed.dtype}, {scales.dtype}")
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"{name}: expected x (m, k), packed and scales of two dimensions")
    if not (x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    check_aligned(name, x, packed, scales)


def _launch_packed(fn_name: str, x, packed, scales, a8: bool, steps: int, nibble: bool, extra: tuple):
    """Allocate the output, the split-k workspace and, for a8, the int8 copy of
    x with its row scales; launch `fn_name`; return y (m, n) f32."""
    m, k = x.shape
    n = packed.shape[1]
    dev = x.device
    splits = _packed_splits(m, n, steps, nibble, dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else y
    args = [x.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(), ws.data_ptr()]
    if a8:
        xq = torch.empty((m, k), dtype=torch.int8, device=dev)
        xs = torch.empty((m,), dtype=torch.float32, device=dev)
        args += [xq.data_ptr(), xs.data_ptr(), int(x.dtype == torch.bfloat16)]
    err = getattr(library(), fn_name)(*args, m, k, n, *extra, splits,
                                      torch.cuda.current_stream(dev).cuda_stream)
    check_launch(fn_name, err)
    return y


def _int4_shapes(name: str, x, packed, scales):
    m, k = x.shape
    kh, n = packed.shape
    if k != 2 * kh or k % (2 * INT4_GROUP) or scales.shape != (k // INT4_GROUP, n) or n % 64:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}: k % 64 == 0 and n % 64 == 0 are needed")
    return kh // 32


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int4_matmul.cu, bf16 route: x (m, k) bf16, packed (k/2, n)
    int8, scales (k/32, n) bf16 -> (m, n) f32. Any m >= 1."""
    _check_packed("int4_matmul_kernel", x, packed, scales, torch.int8, a8=False)
    steps = _int4_shapes("int4_matmul_kernel", x, packed, scales)
    y = _launch_packed("exl3_int4_matmul", x, packed, scales, False, steps, True, ())
    int4_matmul_kernel.launches += 1
    return y


int4_matmul_kernel.launches = 0


def int4_matmul_a8_kernel(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int4_matmul.cu, a8 route: x (m, k) f32 or bf16 is quantized
    to int8 rows by the launch's first kernel; -> (m, n) f32. Any m >= 1."""
    _check_packed("int4_matmul_a8_kernel", x, packed, scales, torch.int8, a8=True)
    steps = _int4_shapes("int4_matmul_a8_kernel", x, packed, scales)
    y = _launch_packed("exl3_int4_matmul_a8", x, packed, scales, True, steps, True, ())
    int4_matmul_a8_kernel.launches += 1
    return y


int4_matmul_a8_kernel.launches = 0


def _intb_shapes(name: str, x, packed, scales, bits: int):
    m, k = x.shape
    kp, n = packed.shape
    if bits not in _INTB_BITS:
        raise ValueError(f"{name}: bits = {bits}")
    W, kp_want, k_pad = intb_geometry(k, bits)
    if kp != kp_want or scales.shape != (k_pad // INTB_GROUP, n) or k % INTB_GROUP or n % 32:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, bits {bits}: k % 32 == 0 and "
                         f"n % 32 == 0 are needed")
    return kp // 32


def intb_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """Launch csrc/intb_matmul.cu, bf16 route: x (m, k) bf16 (k unpadded),
    packed (kp, n) int32, scales (W*kp/32, n) bf16 -> (m, n) f32. Any m >= 1."""
    _check_packed("intb_matmul_kernel", x, packed, scales, torch.int32, a8=False)
    steps = _intb_shapes("intb_matmul_kernel", x, packed, scales, bits)
    y = _launch_packed("exl3_intb_matmul", x, packed, scales, False, steps, False,
                       (packed.shape[0], bits))
    intb_matmul_kernel.launches += 1
    return y


intb_matmul_kernel.launches = 0


def intb_matmul_a8_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """Launch csrc/intb_matmul.cu, a8 route: x (m, k) f32 or bf16, quantized
    to int8 rows by the launch's first kernel; -> (m, n) f32. Any m >= 1."""
    _check_packed("intb_matmul_a8_kernel", x, packed, scales, torch.int32, a8=True)
    steps = _intb_shapes("intb_matmul_a8_kernel", x, packed, scales, bits)
    y = _launch_packed("exl3_intb_matmul_a8", x, packed, scales, True, steps, False,
                       (packed.shape[0], bits))
    intb_matmul_a8_kernel.launches += 1
    return y


intb_matmul_a8_kernel.launches = 0


# -- dispatchers ---------------------------------------------------------------

def _over_rows(x: torch.Tensor, n: int, bias, product) -> torch.Tensor:
    """product(x as (rows, k)) -> (rows, n), plus bias, back in x's leading dims."""
    y = product(x.reshape(-1, x.shape[-1]))
    if bias is not None:
        y = y + bias
    return y.reshape(*x.shape[:-1], n)


def int4_matmul_a8(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                   bias=None) -> torch.Tensor:
    """x (..., k) -> (..., n) f32 through the a8 route."""
    if x.device.type == "cpu":
        product = lambda x2: int4_matmul_a8_plain(x2, packed, scales)
    else:
        product = lambda x2: int4_matmul_a8_kernel(x2.contiguous(), packed, scales)
    return _over_rows(x, packed.shape[1], bias, product)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                bias=None) -> torch.Tensor:
    """x (..., k) -> (..., n) f32: the a8 route unless EXL3TPU_INT4_A8=0."""
    if env_bool("EXL3TPU_INT4_A8", True):
        return int4_matmul_a8(x, packed, scales, bias=bias)
    if x.device.type == "cpu":
        product = lambda x2: int4_matmul_plain(x2, packed, scales)
    else:
        product = lambda x2: int4_matmul_kernel(x2.to(torch.bfloat16).contiguous(), packed, scales)
    return _over_rows(x, packed.shape[1], bias, product)


def intb_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                bits: int | None = None, bias=None) -> torch.Tensor:
    """x (..., k) -> (..., n) f32 over an int-B weight: the a8 route unless
    EXL3TPU_INTB_A8=0; `bits` is read from the shapes when None. x keeps its
    own k: the pad rows sit at the end of the last plane and are skipped."""
    if bits is None:
        bits = intb_bits_from_shapes(packed.shape[0], scales.shape[0])
    a8 = env_bool("EXL3TPU_INTB_A8", True)
    if x.device.type == "cpu":
        plain = intb_matmul_a8_plain if a8 else intb_matmul_plain
        product = lambda x2: plain(x2, packed, scales, bits)
    elif a8:
        product = lambda x2: intb_matmul_a8_kernel(x2.contiguous(), packed, scales, bits)
    else:
        product = lambda x2: intb_matmul_kernel(x2.to(torch.bfloat16).contiguous(), packed,
                                                scales, bits)
    return _over_rows(x, packed.shape[1], bias, product)
