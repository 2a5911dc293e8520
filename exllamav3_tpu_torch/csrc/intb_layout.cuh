// The limits and the shared-memory layout of the staged int-B body
// (csrc/intb_matmul.cu, up to INTB_DECODE_ROWS rows), in plain C++ so that
// host code reads them from here alone: ops/q_matmul.py reads the constants
// through ops/build.py::header_constants, and tests/test_torch_intb_split.py
// compiles this header with a host compiler to hold the sizing's reckoning
// of a block's shared memory to intb_decode_smem.
#pragma once

#ifdef __CUDACC__
#define INTB_HD __host__ __device__
#else
#define INTB_HD
#endif

constexpr int INTB_WARPS = 4;          // warps a block, 32 columns each
constexpr int INTB_STAGES = 3;         // steps of words and scales each warp stages
constexpr int INTB_BLOCKS = 3;         // blocks an SM the launch bounds promise
constexpr int INTB_DECODE_ROWS = 16;   // rows the staged body takes
constexpr int INTB_MAX_SMEM = 231424;  // dynamic shared memory a block may ask for (the
                                       // card's 232448 less room for static shared memory)

// Shared memory of a block: each warp's INTB_STAGES stages, a stage the words
// of one step (32 packed rows of the warp's 32 columns, INTB_WORD_STAGE
// bytes) and one row of the warp's group scales a plane (32 bf16,
// INTB_SCALE_ROW bytes); then x: 8 or 16 rows of W planes x `per` steps x 32
// k, each row rounded up to INTB_X_ALIGN bytes and padded by INTB_X_PAD_A8
// (int8 rows) or INTB_X_PAD_BF16 (bf16 rows) bytes, so that the lanes'
// fragment reads meet no bank twice; then on the a8 route the row sums of
// each (plane, step) group, INTB_X_SUMS bytes a group (16 ints).
constexpr int INTB_WORD_STAGE = 4096;
constexpr int INTB_SCALE_ROW = 64;
constexpr int INTB_X_ALIGN = 128;
constexpr int INTB_X_PAD_A8 = 32;
constexpr int INTB_X_PAD_BF16 = 64;
constexpr int INTB_X_SUMS = 64;
static_assert(INTB_WORD_STAGE == 32 * 32 * 4 && INTB_SCALE_ROW == 32 * 2 &&
                  INTB_X_SUMS == 16 * 4,
              "a stage is 32 rows of 32 words and 32 scales a plane; 16 row sums a group");

namespace {

INTB_HD constexpr int intb_stage_bytes(int W) { return INTB_WORD_STAGE + W * INTB_SCALE_ROW; }
INTB_HD constexpr int intb_x_ld(int W, int per, bool a8) {
    return (W * per * 32 * (a8 ? 1 : 2) + INTB_X_ALIGN - 1) / INTB_X_ALIGN * INTB_X_ALIGN +
           (a8 ? INTB_X_PAD_A8 : INTB_X_PAD_BF16);
}
INTB_HD constexpr int intb_smem_bytes(int W, int per, bool a8, int rows) {
    return INTB_WARPS * INTB_STAGES * intb_stage_bytes(W) + rows * intb_x_ld(W, per, a8) +
           (a8 ? W * per * INTB_X_SUMS : 0);
}

// the staged body's shared memory for these widths (kp packed rows, k split
// `splits` ways), or 0 for a split count that leaves a split without a step
// or asks for more than INTB_MAX_SMEM
inline int intb_decode_smem(int bits, bool a8, int m, int kp, int splits) {
    const int steps = kp / 32;
    if (splits < 1 || splits > steps) return 0;
    const int smem = intb_smem_bytes(32 / bits, (steps + splits - 1) / splits, a8, m <= 8 ? 8 : 16);
    return smem <= INTB_MAX_SMEM ? smem : 0;
}

}  // namespace
