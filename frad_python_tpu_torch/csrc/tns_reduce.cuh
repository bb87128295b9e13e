// The TNS analysis kernels' shared arithmetic: IEEE-rounded operations by
// type, and the block reduction whose order is part of both functions.
//
// A row's sum has SUM_T = 256 owners. Owner t adds the elements t, t + 256,
// t + 512, ... of a row in ascending order, starting from +0 (the row counts
// as padded with +0 to a multiple of 256), then the 256 running sums are
// added as a fixed tree: inside each warp p[i] += p[i + s] for s = 16, 8, 4,
// 2, 1 (shuffles, `warp_sums`), then over the 8 warp sums for s = 4, 2, 1
// (`tree_sum`).
// kernels/tns_autocorr.py:row_sum is the same order in PyTorch. Every sum and
// product is an _rn intrinsic, so nvcc contracts nothing into an FMA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tns {

constexpr int SUM_T = 256;
constexpr int WARPS = SUM_T / 32;
constexpr int ORDER1 = 13;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float exp_t(float a) { return expf(a); }
__device__ __forceinline__ double exp_t(double a) { return exp(a); }
__device__ __forceinline__ float log10_t(float a) { return log10f(a); }
__device__ __forceinline__ double log10_t(double a) { return log10(a); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }

// The K running sums of every thread of a warp -> their warp sums (the
// shuffle tree), which lane 0 writes to scratch[(warp % WARPS) * KT + first
// + k]: a warp w of a block of more than 256 threads holds sums of the owners
// 32 (w % WARPS) .. + 31. After a barrier, `tree_sum` of a slot is the row
// sum, in every thread.
template <typename T, int K>
__device__ __forceinline__ void warp_sums(T (&v)[K], T* scratch, int kt, int first) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            v[k] = add_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], s));
    }
    if ((threadIdx.x & 31) == 0) {
        const int warp = (threadIdx.x >> 5) % WARPS;
#pragma unroll
        for (int k = 0; k < K; ++k) scratch[warp * kt + first + k] = v[k];
    }
}

template <typename T>
__device__ __forceinline__ T tree_sum(const T* scratch, int kt, int slot) {
    T w[WARPS];
#pragma unroll
    for (int j = 0; j < WARPS; ++j) w[j] = scratch[j * kt + slot];
#pragma unroll
    for (int s = WARPS / 2; s > 0; s >>= 1) {
#pragma unroll
        for (int j = 0; j < s; ++j) w[j] = add_rn(w[j], w[j + s]);
    }
    return w[0];
}

}  // namespace tns
