// The limits and the shared-memory layout of the staged int8 body
// (csrc/int8_staged.cuh: the int8 matmul and both phases of the fused MLP,
// up to INT8_DECODE_ROWS rows), in plain C++ so that host code reads them
// from here alone: ops/q_matmul.py reads the constants through
// ops/build.py::header_constants, and tests/test_torch_int8_split.py compiles
// this header with a host compiler to hold the sizing's reckoning of a
// block's shared memory to int8_decode_smem.
#pragma once

#ifdef __CUDACC__
#define INT8_HD __host__ __device__
#else
#define INT8_HD
#endif

constexpr int INT8_WARPS = 4;          // warps a block, 32 columns each
constexpr int INT8_STEP_ROWS = 128;    // k rows a step: 4 groups of 32
constexpr int INT8_STAGES = 3;         // steps of weights each warp stages
constexpr int INT8_BLOCKS = 3;         // blocks an SM the launch bounds promise
constexpr int INT8_DECODE_ROWS = 16;   // rows the staged body takes
constexpr int INT8_MAX_SMEM = 231424;  // dynamic shared memory a block may ask for (the
                                       // card's 232448 less room for static shared memory)
// the last warp of a 32-column tile reads every split's partial sums: at most
// this many splits keeps its reads within 32 KB at 16 rows
constexpr int INT8_MAX_SPLITS = 16;
// the fused MLP's second phase is a programmatic dependent of its first from
// this k (its intermediate width) up, and waits for it in stream order below
// (measured: it gains ~3 us at i = 14336 and 21504, loses ~1 us at 2048)
constexpr int INT8_MLP_PDL_MIN_K = 8192;

// Shared memory of a block: each warp's INT8_STAGES stages, a stage the int8
// weights of one step (128 rows of the warp's 32 columns, INT8_BYTE_STAGE
// bytes); then x: 8 or 16 bf16 rows of `per` steps x 128 k, each row padded
// by INT8_X_PAD bytes, so that the lanes' fragment reads meet no bank twice.
constexpr int INT8_BYTE_STAGE = 4096;
constexpr int INT8_X_PAD = 64;
static_assert(INT8_BYTE_STAGE == INT8_STEP_ROWS * 32 && INT8_STEP_ROWS == 4 * 32,
              "a stage is 128 rows of 32 bytes, 4 groups of 32 rows");

namespace {

INT8_HD constexpr int int8_x_ld(int per) { return per * INT8_STEP_ROWS * 2 + INT8_X_PAD; }
INT8_HD constexpr int int8_smem_bytes(int per, int rows) {
    return INT8_WARPS * INT8_STAGES * INT8_BYTE_STAGE + rows * int8_x_ld(per);
}

// the staged body's shared memory for these widths (k split `splits` ways),
// or 0 for a split count that leaves a split without a step, exceeds
// INT8_MAX_SPLITS or asks for more than INT8_MAX_SMEM
inline int int8_decode_smem(int m, int k, int splits) {
    const int steps = (k + INT8_STEP_ROWS - 1) / INT8_STEP_ROWS;
    if (splits < 1 || splits > steps || splits > INT8_MAX_SPLITS) return 0;
    const int smem = int8_smem_bytes((steps + splits - 1) / splits, m <= 8 ? 8 : 16);
    return smem <= INT8_MAX_SMEM ? smem : 0;
}

}  // namespace
