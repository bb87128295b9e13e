// tns_levinson: Profile 2's order-12 Levinson-Durbin recursion on Hopper.
//
// Replaces the XLA device program `_levinson` of
// frad_python_tpu/ops/tns_jax.py (an unrolled chain of ~400 masked vector
// ops): autocorrelation lags ac [L, 13] -> LPC coefficients lpc [L, 13],
// one lane per (frame, channel), float32 or float64:
//
//   lpc = [1, 0, ...]; error = ac[0]; dead = frozen = error <= 1e-10
//   for i = 1 .. 12:
//     acc   = sum_{j=0..i-1} lpc[j] * ac[i-j]          (j ascending)
//     refl  = -acc / (error == 0 ? 1 : error), clamped to +-0.96
//     upd   = lpc; upd[i] = refl; upd[j] += refl * lpc[i-j]  (1 <= j < i)
//     lpc   = frozen ? lpc : upd
//     error = frozen ? error : error * (1 - refl^2)
//     frozen |= error <= 1e-12
//   dead lanes return [1, 0, ...]
//
// Bound: a launch. The whole batch moves 2 * L * 13 values (143 KB at
// L = 1378, float32) and does ~250 flops a lane; the recursion is a
// scalar chain with data-dependent freezing, so it is neither an
// elementwise pass nor a reduction. Design: one thread per lane, the 13
// lags and 13 coefficients in registers (every loop fully unrolled, so
// all indices are static), one kernel in place of the unrolled chain of
// tiny launches. Every product, sum, difference and quotient is the
// IEEE-rounded intrinsic, so nvcc contracts nothing into an FMA and the
// kernel is bit-identical to the eager PyTorch version
// (frad_python_tpu_torch/kernels/tns_levinson.py:tns_levinson_plain).

#include <cuda_runtime.h>

namespace {

constexpr int ORDER1 = 13;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void tns_levinson_kernel(const T* __restrict__ ac_in,
                                    T* __restrict__ lpc_out, int lanes) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    T ac[ORDER1], lpc[ORDER1];
#pragma unroll
    for (int j = 0; j < ORDER1; ++j) {
        ac[j] = ac_in[(long long)lane * ORDER1 + j];
        lpc[j] = (T)0;
    }
    lpc[0] = (T)1;
    T error = ac[0];
    const bool dead = error <= (T)1e-10;
    bool frozen = dead;
    const T lim = (T)0.96;

#pragma unroll
    for (int i = 1; i < ORDER1; ++i) {
        T acc = (T)0;
#pragma unroll
        for (int j = 0; j < i; ++j) acc = add_rn(acc, mul_rn(lpc[j], ac[i - j]));
        T safe_err = error == (T)0 ? (T)1 : error;
        T refl = div_rn(-acc, safe_err);
        if (refl >= lim) refl = lim;
        else if (refl <= -lim) refl = -lim;

        T upd[ORDER1];
#pragma unroll
        for (int j = 0; j < ORDER1; ++j) upd[j] = lpc[j];
        upd[i] = refl;
#pragma unroll
        for (int j = 1; j < i; ++j) upd[j] = add_rn(lpc[j], mul_rn(refl, lpc[i - j]));
        T new_err = mul_rn(error, sub_rn((T)1, mul_rn(refl, refl)));
        if (!frozen) {
#pragma unroll
            for (int j = 0; j < ORDER1; ++j) lpc[j] = upd[j];
            error = new_err;
        }
        frozen = frozen || (error <= (T)1e-12);
    }

#pragma unroll
    for (int j = 0; j < ORDER1; ++j) {
        T v = dead ? (j == 0 ? (T)1 : (T)0) : lpc[j];
        lpc_out[(long long)lane * ORDER1 + j] = v;
    }
}

}  // namespace

extern "C" int frad_tns_levinson(const void* ac, void* lpc, int lanes,
                                 int is_f64, void* stream) {
    if (lanes <= 0) return 0;
    const int threads = 64;
    int blocks = (lanes + threads - 1) / threads;
    if (is_f64)
        tns_levinson_kernel<double><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const double*)ac, (double*)lpc, lanes);
    else
        tns_levinson_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)ac, (float*)lpc, lanes);
    return (int)cudaGetLastError();
}
