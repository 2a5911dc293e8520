// Fused decode MLP for Hopper:
//   acc = bf16(act(x@Wg*sg) * (x@Wu*su)) @ Wd
// (m <= 16 rows, f32 out), times the down scale and plus the down bias where
// the caller hands them over (each one f32 operation, as the caller's own
// multiply and add).
//
// Replaces: exllamav3_tpu/ops/fused_mlp.py::_fused_mlp_kernel
//           (fused_mlp_int8_pallas, dispatched by fused_mlp_int8).
// Inputs:   x (m, h) bf16; gu (h, 2i) int8 [gate | up]; gu_scale (2i,) f32;
//           d (i, h) int8; h % 256 == 0, i % 128 == 0 (checked in Python);
//           act: 0 silu, 1 gelu (erf), 2 gelu_pytorch_tanh, 3 relu2, an
//           argument of the first phase's epilogue, taken in f32 before the
//           bf16 round as the JAX kernel's _act does; clamp > 0 (DeepSeek-V4's
//           swiglu_limit) clips the scaled gate to [-clamp, clamp] before the
//           activation, as that _act does (the up product stays as it is).
// Bound:    the weight bytes (3*h*i int8) over 3.35 TB/s; the operations
//           (6*m*h*i) are far below the tensor-core rate at m <= 16.
// Design:   the TPU grid walked intermediate tiles in order with one
//           resident accumulator. On the card the MLP is two launches of the
//           staged int8 body (csrc/int8_staged.cuh), each spread over every
//           SM by its own k split: the first over gu with k = h, whose
//           epilogue (in the last split of a tile to arrive) takes the
//           activation and writes a (m, i) bf16, at most 16 x 21504 x 2 bytes;
//           the second over a and d with k = i, whose epilogue applies the
//           down scale and bias. From i = INT8_MLP_PDL_MIN_K up the second is
//           a programmatic dependent of the first: it stages its first step of
//           d, which does not depend on a, before it waits for the first
//           phase's writes. The two phases share the split-k workspace and the
//           arrival counters: the second touches either only after its wait.
//           Weights cross device memory once as int8; a crosses it as bf16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_staged.cuh"

// the fused MLP's kernel launches in this library, counted where they are
// made (read through exl3_fused_mlp_launches): first phases, second phases
static int mlp_launch_count[2] = {0, 0};

// splits1, splits2: the k splits of the two phases (each leaves no split
// without a step); ws (max(splits1 * 2i, splits2 * h) * m f32) may be null
// where both are 1; counters: one int32 a 32-column tile of the wider phase,
// 0 before the launch and left 0 after it. d_scale, d_bias (h,) f32 may be
// null.
extern "C" int exl3_fused_mlp(const void* x, const void* gu, const void* gu_scale, const void* d,
                              const void* d_scale, const void* d_bias, void* a, void* out,
                              void* ws, void* counters, int m, int h, int inter, int act,
                              float clamp, int splits1, int splits2, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || m > INT8_DECODE_ROWS || h % 256 || inter % 128) return (int)cudaErrorInvalidValue;
    if (act < int8s::SILU || act > int8s::RELU2) return (int)cudaErrorInvalidValue;
    int err = int8s::launch<int8s::GATE_UP, false>(x, gu, static_cast<const float*>(gu_scale), nullptr,
                                                   a, ws, counters, m, h, 2 * inter, inter, splits1,
                                                   act, clamp, false, st);
    if (err != 0) return err;
    ++mlp_launch_count[0];
    err = int8s::launch<int8s::SCALED, true>(
        a, d, static_cast<const float*>(d_scale), static_cast<const float*>(d_bias), out, ws, counters,
        m, inter, h, 0, splits2, 0, 0.0f, inter >= INT8_MLP_PDL_MIN_K, st);
    if (err == 0) ++mlp_launch_count[1];
    return err;
}

// fused MLP launches so far by kernel: 0 first phases, 1 second phases; -1
// for another kind
extern "C" int exl3_fused_mlp_launches(int kind) {
    return kind >= 0 && kind < 2 ? mlp_launch_count[kind] : -1;
}
