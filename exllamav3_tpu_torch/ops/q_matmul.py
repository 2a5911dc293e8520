"""Quantized-weight matmuls of the materialized linear modes
(counterpart of exllamav3_tpu/ops/q_matmul.py).

  * int8: y = (x @ W_q) * scale[col], 1 byte a weight (csrc/int8_matmul.cu; at
    m <= 16 the staged body of csrc/int8_staged.cuh, int8_matmul_split_plain
    its arithmetic);
  * int4: grouped 4-bit codes, two a byte along k, one bf16 scale per 32 rows
    and column: 0.5625 bytes a weight (csrc/int4_matmul.cu; both routes at
    m <= 16 over one staged body, int4_matmul_a8_split_plain and
    int4_matmul_split_plain its arithmetic);
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

import functools

import numpy as np
import torch

from ..util.device import H100_SMS, arrival_counters, device_sms, scratch
from ..util.env import env_bool
from .build import check_aligned, check_launch, header_constants, library

SMALL_M = 16  # rows up to this take the staged bodies (int8, int4 a8, int-B)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (m, k); w_q (k, n) int8; scale (n,) f32 -> (m, n) f32: bf16 x,
    bf16-exact weights, f32 accumulation."""
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return y * scale[None, :].to(torch.float32)


def int8_matmul_split_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor | None,
                            splits: int) -> torch.Tensor:
    """The staged int8 body's arithmetic in plain torch (m <= 16,
    csrc/int8_staged.cuh): the k steps (INT8_STEP_ROWS rows; the last may be
    short) cut into `splits` runs as the kernel cuts them, each run's partial
    sums of bf16 x times the bf16-exact weights in f32, the partials added in
    split order from 0, then times the column scale (none where scale is
    None). (m, n) f32."""
    m, k = x.shape
    xf, wf = x.to(torch.bfloat16).float(), w_q.float()
    out = torch.zeros((m, w_q.shape[1]), dtype=torch.float32, device=x.device)
    for s0, s1 in _intb_split_steps(-(-k // INT8_STEP_ROWS), splits):
        r0, r1 = s0 * INT8_STEP_ROWS, min(s1 * INT8_STEP_ROWS, k)
        out = out + xf[:, r0:r1] @ wf[r0:r1]
    return out if scale is None else out * scale[None, :].to(torch.float32)


def _split_k(tiles: int, k_tiles: int, device) -> int:
    """The tiled kernel's k splits (above INT8_DECODE_ROWS rows): split the k
    loop until the grid has about two blocks per SM, keeping at least two k
    tiles per split."""
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    s = 1
    while tiles * s < target and k_tiles % (2 * s) == 0 and k_tiles // (2 * s) >= 2:
        s *= 2
    return s


def int8_matmul_kernel(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int8_matmul.cu: x (m, k) bf16, w_q (k, n) int8, scale (n,)
    f32, all contiguous on one CUDA device; k % 64 == 0, n % 64 == 0. Up to
    INT8_DECODE_ROWS rows one staged product kernel a call, its splits sized
    by int8_split_count and added in the launch (the shared arrival counters,
    one a 32-column tile); above, 128 x 128 x 32 tiles with a split-k reduce.
    The partial sums go to the device's scratch buffer."""
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
    if m <= INT8_DECODE_ROWS:
        splits = int8_split_count(m, k, n, device_sms(x.device))
        counters = arrival_counters(x.device, n // 32).data_ptr()  # one a warp's columns
    else:
        splits, counters = _split_k(-(-n // 128) * -(-m // 128), k // 32, x.device), None
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = scratch(x.device, splits * m * n * 4).data_ptr() if splits > 1 else None
    err = library().exl3_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), ws, counters,
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


def _intb_split_steps(steps: int, splits: int) -> list:
    """The step runs [s * steps // splits, (s + 1) * steps // splits) of the
    staged int-B kernel's splits: lengths differ by at most one step."""
    return [(s * steps // splits, (s + 1) * steps // splits) for s in range(splits)]


def intb_matmul_split_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                            bits: int, splits: int, a8: bool) -> torch.Tensor:
    """The staged int-B kernel's arithmetic in plain torch (m <= 16): the
    steps (32 packed rows, every plane) cut into `splits` runs as the kernel
    cuts them, each run's partial sums in f32 (the a8 route: an exact integer
    dot per 32-row group times its scale), the partials added in split order
    from 0, and on the a8 route the row scale last. (m, n) f32."""
    m, k = x.shape
    W, kp, _ = intb_geometry(k, bits)
    codes = _intb_codes(packed, bits)                   # (W * kp, n), pad rows included
    if a8:
        xq, xs = quantize_rows(x)
        xin = xq
    else:
        xin = x.to(torch.bfloat16).float()
        w = (codes.to(torch.float32) * scales.to(torch.float32).repeat_interleave(INTB_GROUP, 0)
             ).to(torch.bfloat16).float()
    out = torch.zeros((m, packed.shape[1]), dtype=torch.float32, device=x.device)
    for s0, s1 in _intb_split_steps(kp // 32, splits):
        # the split's weight rows in every plane, short of the pad rows
        runs = [(j * kp + s0 * 32, min(j * kp + s1 * 32, k)) for j in range(W)
                if j * kp + s0 * 32 < k]
        rows = torch.cat([torch.arange(r0, r1, device=x.device) for r0, r1 in runs])
        if a8:
            groups = rows[::INTB_GROUP] // INTB_GROUP
            xg = xin[:, rows].reshape(m, -1, INTB_GROUP).transpose(0, 1)   # (groups, m, 32)
            cg = codes[rows].reshape(-1, INTB_GROUP, codes.shape[1]).to(torch.float32)
            d = torch.bmm(xg, cg)                                            # exact integers
            part = (d * scales[groups][:, None, :].to(torch.float32)).sum(dim=0)
        else:
            part = xin[:, rows] @ w[rows]
        out = out + part
    return out * xs if a8 else out


def _int4_split_rows(k: int, splits: int, device) -> list:
    """The weight rows of each split of the staged int4 body, in split order:
    the steps (INT4_STEP_ROWS packed rows, both planes; the last may be
    short) cut into `splits` runs as the kernel cuts them."""
    kh = k // 2
    out = []
    for s0, s1 in _intb_split_steps(-(-kh // INT4_STEP_ROWS), splits):
        r0, r1 = s0 * INT4_STEP_ROWS, min(s1 * INT4_STEP_ROWS, kh)
        out.append(torch.cat([torch.arange(j * kh + r0, j * kh + r1, device=device)
                              for j in (0, 1)]))
    return out


def int4_matmul_split_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                            splits: int) -> torch.Tensor:
    """The staged int4 kernel's arithmetic in plain torch on the bf16 route
    (m <= 16): each split's partial sums of bf16 x times the weights
    bf16((nibble - 8) * scale) in f32, the partials added in split order
    from 0. (m, n) f32."""
    xf = x.to(torch.bfloat16).float()
    w = int4_unpack(packed, scales).to(torch.bfloat16).float()
    out = torch.zeros((x.shape[0], packed.shape[1]), dtype=torch.float32, device=x.device)
    for rows in _int4_split_rows(x.shape[1], splits, x.device):
        out = out + xf[:, rows] @ w[rows]
    return out


def int4_matmul_a8_split_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                               splits: int) -> torch.Tensor:
    """The staged int4 a8 kernel's arithmetic in plain torch (m <= 16): the
    splits' weight rows as _int4_split_rows cuts them, each run's partial
    sums in f32 (an exact integer dot per 32-row group times its scale), the
    partials added in split order from 0, and the row scale last. (m, n)
    f32."""
    m, k = x.shape
    codes = _int4_codes(packed)                          # (k, n): plane 0 rows, then plane 1
    xq, xs = quantize_rows(x)
    out = torch.zeros((m, packed.shape[1]), dtype=torch.float32, device=x.device)
    for rows in _int4_split_rows(k, splits, x.device):
        groups = rows[::INT4_GROUP] // INT4_GROUP
        xg = xq[:, rows].reshape(m, -1, INT4_GROUP).transpose(0, 1)      # (groups, m, 32)
        cg = codes[rows].reshape(-1, INT4_GROUP, codes.shape[1]).to(torch.float32)
        d = torch.bmm(xg, cg)                                             # exact integers
        out = out + (d * scales[groups][:, None, :].to(torch.float32)).sum(dim=0)
    return out * xs


# -- kernel wrappers -----------------------------------------------------------

# the tilings of csrc/packed_matmul.cuh, which the int4 kernels take above
# INT4_DECODE_ROWS rows and the int-B kernels above INTB_DECODE_ROWS rows
# (the staged bodies below those are sized by int4_split_count and
# intb_split_count below): up to DECODE_ROWS rows a block covers 16 rows and
# 256 (int4) or 128 (int-B) columns, beyond that 64 rows and 128 columns; one
# step of its k loop is 32 packed rows
DECODE_ROWS = 16
BLOCKS_PER_SM = 4
MIN_STEPS = 4


def _packed_splits(m: int, n: int, steps: int, nibble: bool, device) -> int:
    """k splits of a grid of packed_matmul.cuh (the int4 and int-B kernels
    above 16 rows): enough blocks to fill the card
    at decode sizes, MIN_STEPS steps a split where there are that many, and
    no split left empty."""
    if m <= DECODE_ROWS:
        blocks = -(-n // (256 if nibble else 128))
    else:
        blocks = -(-n // 128) * -(-m // 64)
    target = BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(steps // MIN_STEPS, -(-target // blocks)))
    per = -(-steps // want)
    return -(-steps // per)


# the staged int-B kernel's limits and layout, read from csrc/intb_layout.cuh:
# up to INTB_DECODE_ROWS rows, blocks of INTB_WARPS warps of 32 columns, each
# warp staging INTB_STAGES steps of its words and scales; the launch bounds
# promise INTB_BLOCKS blocks an SM; a block may ask for INTB_MAX_SMEM bytes;
# the byte sizes of a block's shared memory (_intb_smem)
_INTB_LAYOUT = ("INTB_WARPS", "INTB_STAGES", "INTB_BLOCKS", "INTB_DECODE_ROWS", "INTB_MAX_SMEM",
                "INTB_WORD_STAGE", "INTB_SCALE_ROW", "INTB_X_ALIGN", "INTB_X_PAD_A8",
                "INTB_X_PAD_BF16", "INTB_X_SUMS")
(_INTB_WARPS, _INTB_STAGES, _INTB_BLOCKS, INTB_DECODE_ROWS, INTB_MAX_SMEM, _INTB_WORD_STAGE,
 _INTB_SCALE_ROW, _INTB_X_ALIGN, _INTB_X_PAD_A8, _INTB_X_PAD_BF16, _INTB_X_SUMS) = header_constants(
    "intb_layout.cuh", *_INTB_LAYOUT)
_INTB_BN = 32 * _INTB_WARPS
# an SM's shared memory for blocks, 1 KB of it reserved a block
_SM_SHARED, _BLOCK_RESERVED = header_constants("attention_decode.cuh", "SM_SHARED",
                                               "BLOCK_RESERVED")


def _intb_smem(m: int, bits: int, a8: bool, per: int) -> int:
    """Dynamic shared memory of a staged int-B block whose split holds `per`
    steps, as csrc/intb_layout.cuh's intb_smem_bytes reckons it from the
    same constants: each warp's stages of words and scales, 8 or 16 rows of
    x over the split's groups in padded rows, and the a8 row sums.
    tests/test_torch_intb_split.py holds it to the header, compiled."""
    W = 32 // bits
    x_ld = (-(-W * per * 32 * (1 if a8 else 2) // _INTB_X_ALIGN) * _INTB_X_ALIGN
            + (_INTB_X_PAD_A8 if a8 else _INTB_X_PAD_BF16))
    return (_INTB_WARPS * _INTB_STAGES * (_INTB_WORD_STAGE + W * _INTB_SCALE_ROW)
            + (8 if m <= 8 else 16) * x_ld + (W * per * _INTB_X_SUMS if a8 else 0))


def _intb_blocks_per_sm(m: int, bits: int, a8: bool, per: int) -> int:
    """Blocks an SM holds of a staged int-B launch: the launch bounds, or
    fewer where the shared memory does not fit. chip_smoke.py holds it to the
    card's reading (exl3_intb_blocks_per_sm)."""
    return min(_INTB_BLOCKS, _SM_SHARED // (_intb_smem(m, bits, a8, per) + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)  # a served step asks for a few widths hundreds of times
def intb_split_count(m: int, k: int, n: int, bits: int, a8: bool, sms: int = H100_SMS) -> int:
    """k splits of the staged int-B kernel on a card of `sms` SMs (m <=
    INTB_DECODE_ROWS), by the busiest SM's steps (_busiest_sm_splits)."""
    return _busiest_sm_splits(intb_geometry(k, bits)[1] // 32, -(-n // _INTB_BN), sms,
                              lambda per: _intb_smem(m, bits, a8, per),
                              lambda per: _intb_blocks_per_sm(m, bits, a8, per), INTB_MAX_SMEM)


# the staged int4 kernel's limits and layout, read from csrc/int4_layout.cuh:
# up to INT4_DECODE_ROWS rows, blocks of INT4_WARPS warps of 32 columns, a k
# step of INT4_STEP_ROWS packed rows, each warp staging INT4_STAGES steps of
# its bytes and scales; the launch bounds promise INT4_BLOCKS blocks an SM; a
# block may ask for INT4_MAX_SMEM bytes; the byte sizes of a block's shared
# memory (_int4_smem)
_INT4_LAYOUT = ("INT4_WARPS", "INT4_STEP_ROWS", "INT4_STAGES", "INT4_BLOCKS", "INT4_DECODE_ROWS",
                "INT4_MAX_SMEM", "INT4_BYTE_STAGE", "INT4_SCALE_STAGE", "INT4_X_ALIGN",
                "INT4_X_PAD", "INT4_X_PAD_BF16", "INT4_X_SUMS")
(_INT4_WARPS, INT4_STEP_ROWS, _INT4_STAGES, _INT4_BLOCKS, INT4_DECODE_ROWS, INT4_MAX_SMEM,
 _INT4_BYTE_STAGE, _INT4_SCALE_STAGE, _INT4_X_ALIGN, _INT4_X_PAD, _INT4_X_PAD_BF16,
 _INT4_X_SUMS) = header_constants("int4_layout.cuh", *_INT4_LAYOUT)
_INT4_BN = 32 * _INT4_WARPS
# the last warp of a 32-column tile reads every split's partial sums: at most
# this many splits keeps its reads within 32 KB at 16 rows
INT4_MAX_SPLITS = 16


def _int4_smem(m: int, per: int, a8: bool) -> int:
    """Dynamic shared memory of a staged int4 block whose split holds `per`
    steps, as csrc/int4_layout.cuh's int4_smem_bytes reckons it from the
    same constants: each warp's stages of bytes and scales, 8 or 16 rows of x
    (int8 on the a8 route, bf16 on the bf16 route) over the split's steps of
    both planes in padded rows, and on the a8 route the row sums of each
    group. tests/test_torch_int4_split.py holds it to the header, compiled."""
    x_ld = (-(-2 * per * INT4_STEP_ROWS * (1 if a8 else 2) // _INT4_X_ALIGN) * _INT4_X_ALIGN
            + (_INT4_X_PAD if a8 else _INT4_X_PAD_BF16))
    return (_INT4_WARPS * _INT4_STAGES * (_INT4_BYTE_STAGE + _INT4_SCALE_STAGE)
            + (8 if m <= 8 else 16) * x_ld + (2 * per * 4 * _INT4_X_SUMS if a8 else 0))


def _int4_blocks_per_sm(m: int, per: int, a8: bool) -> int:
    """Blocks an SM holds of a staged int4 launch: the launch bounds, or
    fewer where the shared memory does not fit. chip_smoke.py holds it to the
    card's reading (exl3_int4_blocks_per_sm)."""
    return min(_INT4_BLOCKS, _SM_SHARED // (_int4_smem(m, per, a8) + _BLOCK_RESERVED))


def _busiest_sm_splits(steps: int, tiles: int, sms: int, smem, blocks_per_sm,
                       max_smem: int, max_splits: int | None = None,
                       one_resident: bool = True) -> int:
    """The split count of a staged kernel (int-B, int4 a8, int8): a block's
    time is its steps, the card's that of its busiest SM: the blocks it is
    given times their steps, ceil(tiles * splits / sms) * ceil(steps /
    splits). Among the splits whose x fits a block's shared memory (smem(per)
    <= max_smem) and whose grid is resident at once (or, where none is, all
    that fit), those that give the busiest SM the fewest steps are taken, and
    of them the one whose SMs run the most blocks at once (warps that hide
    each other's latency), then the fewest splits; at most max_splits. One
    split counts as resident whatever its grid unless one_resident is False:
    then a single split whose blocks an SM cannot hold at once competes with
    the others on steps."""
    fits, resident = [], []
    for s in range(1, min(steps, max_splits or steps) + 1):
        per = -(-steps // s)
        if smem(per) > max_smem:
            continue
        held = blocks_per_sm(per)
        on_sm = -(-tiles * s // sms)  # blocks the busiest SM is given
        cand = (on_sm * per, -min(on_sm, held), s)
        fits.append(cand)
        if (s == 1 and one_resident) or on_sm <= held:
            resident.append(cand)
    return min(resident or fits)[2]


@functools.lru_cache(maxsize=None)  # a served step asks for a few widths hundreds of times
def int4_split_count(m: int, k: int, n: int, sms: int = H100_SMS, a8: bool = True) -> int:
    """k splits of the staged int4 kernel on the a8 or the bf16 route on a
    card of `sms` SMs (m <= INT4_DECODE_ROWS), by the busiest SM's steps
    (_busiest_sm_splits), at most INT4_MAX_SPLITS."""
    return _busiest_sm_splits(-(-k // 2 // INT4_STEP_ROWS), -(-n // _INT4_BN), sms,
                              lambda per: _int4_smem(m, per, a8),
                              lambda per: _int4_blocks_per_sm(m, per, a8), INT4_MAX_SMEM,
                              INT4_MAX_SPLITS)


# the staged int8 body's limits and layout, read from csrc/int8_layout.cuh:
# up to INT8_DECODE_ROWS rows, blocks of INT8_WARPS warps of 32 columns, a k
# step of INT8_STEP_ROWS rows, each warp staging INT8_STAGES steps; the launch
# bounds promise INT8_BLOCKS blocks an SM; a block may ask for INT8_MAX_SMEM
# bytes; at most INT8_MAX_SPLITS splits; the byte sizes of a block's shared
# memory (_int8_smem)
_INT8_LAYOUT = ("INT8_WARPS", "INT8_STEP_ROWS", "INT8_STAGES", "INT8_BLOCKS", "INT8_DECODE_ROWS",
                "INT8_MAX_SMEM", "INT8_MAX_SPLITS", "INT8_BYTE_STAGE", "INT8_X_PAD")
(_INT8_WARPS, INT8_STEP_ROWS, _INT8_STAGES, _INT8_BLOCKS, INT8_DECODE_ROWS, INT8_MAX_SMEM,
 INT8_MAX_SPLITS, _INT8_BYTE_STAGE, _INT8_X_PAD) = header_constants("int8_layout.cuh", *_INT8_LAYOUT)
_INT8_BN = 32 * _INT8_WARPS


def _int8_smem(m: int, per: int) -> int:
    """Dynamic shared memory of a staged int8 block whose split holds `per`
    steps, as csrc/int8_layout.cuh's int8_smem_bytes reckons it from the same
    constants: each warp's stages of weights, then 8 or 16 bf16 rows of x
    over the split's steps in padded rows. tests/test_torch_int8_split.py
    holds it to the header, compiled."""
    return (_INT8_WARPS * _INT8_STAGES * _INT8_BYTE_STAGE
            + (8 if m <= 8 else 16) * (per * INT8_STEP_ROWS * 2 + _INT8_X_PAD))


def _int8_blocks_per_sm(m: int, per: int) -> int:
    """Blocks an SM holds of a staged int8 launch: the launch bounds, or fewer
    where the shared memory does not fit. chip_smoke.py holds it to the
    card's reading (exl3_int8_blocks_per_sm)."""
    return min(_INT8_BLOCKS, _SM_SHARED // (_int8_smem(m, per) + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)  # a served step asks for a few widths hundreds of times
def int8_split_count(m: int, k: int, n: int, sms: int = H100_SMS) -> int:
    """k splits of the staged int8 body on a card of `sms` SMs (m <=
    INT8_DECODE_ROWS; the int8 matmul, and each phase of the fused MLP with n
    its staged columns), by the busiest SM's steps (_busiest_sm_splits), at
    most INT8_MAX_SPLITS. A single split whose grid is not resident at once
    competes with the others (measured on an H100: Gemma-3-27B's first MLP
    phase, 336 tiles of 42 steps at one block an SM; 7 splits took the MLP
    from 0.2151-0.2278 to 0.2075-0.2089 ms, PERF.md)."""
    return _busiest_sm_splits(-(-k // INT8_STEP_ROWS), -(-n // _INT8_BN), sms,
                              lambda per: _int8_smem(m, per),
                              lambda per: _int8_blocks_per_sm(m, per), INT8_MAX_SMEM,
                              INT8_MAX_SPLITS, one_resident=False)


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


def _launch_packed(fn_name: str, x, packed, scales, a8: bool, splits: int, extra: tuple,
                   counters: tuple = ()):
    """Allocate the output, the split-k workspace and, for a8, the int8 copy of
    x with its row scales; launch `fn_name` with `splits` k splits (and the
    arrival counters' pointer where the entry takes one); return y (m, n) f32."""
    m, k = x.shape
    n = packed.shape[1]
    dev = x.device
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else y
    args = [x.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(), ws.data_ptr(),
            *counters]
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


def _int4_splits(x, packed, a8: bool) -> tuple:
    """(splits, the arrival counters' pointer or None) of an int4 product:
    up to INT4_DECODE_ROWS rows the staged body's, sized by int4_split_count
    for the route (the shared arrival counters, one a 32-column tile); above,
    packed_matmul.cuh's tiling with its split-k reduce."""
    m, k = x.shape
    n = packed.shape[1]
    if m <= INT4_DECODE_ROWS:
        return (int4_split_count(m, k, n, device_sms(x.device), a8),
                arrival_counters(x.device, n // 32).data_ptr())
    return _packed_splits(m, n, k // 64, True, x.device), None


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int4_matmul.cu, bf16 route: x (m, k) bf16, packed (k/2, n)
    int8, scales (k/32, n) bf16 -> (m, n) f32. Any m >= 1; up to
    INT4_DECODE_ROWS rows one staged product kernel a call
    (_int4_splits)."""
    _check_packed("int4_matmul_kernel", x, packed, scales, torch.int8, a8=False)
    _int4_shapes("int4_matmul_kernel", x, packed, scales)
    splits, counters = _int4_splits(x, packed, False)
    y = _launch_packed("exl3_int4_matmul", x, packed, scales, False, splits, (), (counters,))
    int4_matmul_kernel.launches += 1
    return y


int4_matmul_kernel.launches = 0


def int4_matmul_a8_kernel(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int4_matmul.cu, a8 route: x (m, k) f32 or bf16 is quantized
    to int8 rows by the launch's first kernel; -> (m, n) f32. Any m >= 1; up
    to INT4_DECODE_ROWS rows the quantizer and one staged product kernel a
    call (_int4_splits)."""
    _check_packed("int4_matmul_a8_kernel", x, packed, scales, torch.int8, a8=True)
    _int4_shapes("int4_matmul_a8_kernel", x, packed, scales)
    splits, counters = _int4_splits(x, packed, True)
    y = _launch_packed("exl3_int4_matmul_a8", x, packed, scales, True, splits, (), (counters,))
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


def _launch_intb(fn_name: str, x, packed, scales, bits: int, a8: bool):
    """One int-B product: up to INTB_DECODE_ROWS rows the staged kernel with
    intb_split_count's splits, added in the launch (the shared arrival
    counters, one a 32-column tile); above, packed_matmul.cuh's tiling with
    its split-k reduce."""
    m, k = x.shape
    kp, n = packed.shape
    if m <= INTB_DECODE_ROWS:
        splits = intb_split_count(m, k, n, bits, a8, device_sms(x.device))
        counters = arrival_counters(x.device, n // 32).data_ptr()  # one a warp's columns
    else:
        splits, counters = _packed_splits(m, n, kp // 32, False, x.device), None
    return _launch_packed(fn_name, x, packed, scales, a8, splits, (kp, bits), (counters,))


def intb_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """Launch csrc/intb_matmul.cu, bf16 route: x (m, k) bf16 (k unpadded),
    packed (kp, n) int32, scales (W*kp/32, n) bf16 -> (m, n) f32. Any m >= 1;
    up to INTB_DECODE_ROWS rows one device kernel a call."""
    _check_packed("intb_matmul_kernel", x, packed, scales, torch.int32, a8=False)
    _intb_shapes("intb_matmul_kernel", x, packed, scales, bits)
    y = _launch_intb("exl3_intb_matmul", x, packed, scales, bits, False)
    intb_matmul_kernel.launches += 1
    return y


intb_matmul_kernel.launches = 0


def intb_matmul_a8_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """Launch csrc/intb_matmul.cu, a8 route: x (m, k) f32 or bf16, quantized
    to int8 rows by the launch's first kernel; -> (m, n) f32. Any m >= 1; up
    to INTB_DECODE_ROWS rows the quantizer and one product kernel a call."""
    _check_packed("intb_matmul_a8_kernel", x, packed, scales, torch.int32, a8=True)
    _intb_shapes("intb_matmul_a8_kernel", x, packed, scales, bits)
    y = _launch_intb("exl3_intb_matmul_a8", x, packed, scales, bits, True)
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
