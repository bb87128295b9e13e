// thres_expand: the lossy decoders' threshold expansion on Hopper, the
// elementwise stage before the interpolation GEMM.
//
// Replaces the head of the XLA device programs
// frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit
// (`(e/2) ** quant_jnp(thres)`, about eight launches as eager PyTorch ops):
//
//   out[b, c, band] = (e/2)^(sign(t) * sqrt(|t| * sqrt(|t|))),
//   t = thres[b, band, c]
//
// The input is the payload's [B, 27, C] layout, the output the row layout
// [B * C, 27] the interpolation GEMM reads, so the transpose is part of the
// kernel.
//
// Bound: a launch (37 k elements at 689 frames of 2 channels; 149 KB each
// way). Design: one thread per output element. The arithmetic repeats the
// plain version's operations one rounding each
// (kernels/thres_expand.py:thres_expand_plain): both square roots correctly
// rounded, the product an _rn intrinsic, the sign as (t > 0) - (t < 0) times
// the root (0 stays +0, a NaN stays NaN), powf / pow with the base e/2
// rounded to the compute type as the plain version's 0-dim tensor holds it.

#include <cuda_runtime.h>

namespace {

constexpr int SUBBANDS = 27;

__device__ __forceinline__ float pow_t(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double pow_t(double a, double e) { return pow(a, e); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void thres_expand_kernel(const T* __restrict__ thres, T* __restrict__ out, int B,
                                    int C, T e_half) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)B * C * SUBBANDS) return;
    const int band = (int)(i % SUBBANDS);
    const long long bc = i / SUBBANDS;
    const int c = (int)(bc % C);
    const long long b = bc / C;
    const T t = thres[(b * SUBBANDS + band) * C + c];
    const T a = abs_t(t);
    const T sgn = (T)((t > (T)0) - (t < (T)0));
    out[i] = pow_t(e_half, mul_rn(sgn, sqrt_rn(mul_rn(a, sqrt_rn(a)))));
}

}  // namespace

extern "C" int frad_thres_expand(const void* thres, void* out, int B, int C, double e_half,
                                 int is_f64, void* stream) {
    const long long n = (long long)B * C * SUBBANDS;
    if (n <= 0) return 0;
    const int threads = 128;
    const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        thres_expand_kernel<double><<<blocks, threads, 0, s>>>(
            (const double*)thres, (double*)out, B, C, e_half);
    else
        thres_expand_kernel<float><<<blocks, threads, 0, s>>>(
            (const float*)thres, (float*)out, B, C, (float)e_half);
    return (int)cudaGetLastError();
}
