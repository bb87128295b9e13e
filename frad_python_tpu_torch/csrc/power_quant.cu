// power_quant: the lossy encoders' quantisation epilogue on Hopper.
//
// Replaces the Pallas kernel `power_quant` (`_quant_kernel`) of
// frad_python_tpu/research/pallas_kernels.py, in the JAX product's sqrt
// form (frad_python_tpu/ops/psycho.py:quant_jnp):
//
//   q = div == 0 ? 0 : rint(sign(x) * sqrt(|x| * sqrt(|x|))),  x = f / div * factor
//
// over [R, N] inputs (R = frames * channels): float32 into int32, or
// float64 into int64. With a null `div` (Profile 2, which divides before
// its TNS analysis and compands the residual after) x = f * factor.
//
// Bound: bytes. Each element reads 8 bytes and writes 4 (float32; 4 and 4
// without a divisor) for a handful of flops, far below the card's
// flop-per-byte balance, so the kernel runs at memory bandwidth at best.
// Design: one thread per element, neighbouring
// threads on neighbouring elements along N, so every load and store of a
// warp is one coalesced 128-byte transaction; no shared memory, nothing
// kept between elements. Division and square roots are the IEEE-rounded
// intrinsics and rounding is round-half-even (__float2int_rn /
// __double2ll_rn, not round), so the result is bit-identical to the eager
// PyTorch version
// (frad_python_tpu_torch/kernels/power_quant.py:power_quant_plain).
// Vectorised 16-byte loads and fusing into the DCT GEMM's epilogue are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ int32_t to_int_rn(float a) { return __float2int_rn(a); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ long long to_int_rn(double a) { return __double2ll_rn(a); }

template <typename T, typename I>
__global__ void power_quant_kernel(const T* __restrict__ freqs,
                                   const T* __restrict__ div,   // may be null
                                   I* __restrict__ out,
                                   long long n, T factor) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    T f = freqs[i];
    I q = 0;
    bool zero = false;
    if (div != nullptr) {
        T d = div[i];
        zero = d == (T)0;
        if (!zero) f = div_rn(f, d);
    }
    if (!zero) {
        T x = mul_rn(f, factor);
        T a = x < (T)0 ? -x : x;
        T m = sqrt_rn(mul_rn(a, sqrt_rn(a)));
        T s = x > (T)0 ? m : (x < (T)0 ? -m : (T)0);
        q = (I)to_int_rn(s);
    }
    out[i] = q;
}

}  // namespace

extern "C" int frad_power_quant(const void* freqs, const void* div, void* out,
                                long long n, double factor, int is_f64,
                                void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        power_quant_kernel<double, long long><<<blocks, threads, 0, s>>>(
            (const double*)freqs, (const double*)div, (long long*)out, n, factor);
    else
        power_quant_kernel<float, int32_t><<<blocks, threads, 0, s>>>(
            (const float*)freqs, (const float*)div, (int32_t*)out, n, (float)factor);
    return (int)cudaGetLastError();
}
