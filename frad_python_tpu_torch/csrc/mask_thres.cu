// mask_thres: the lossy encoders' masking-threshold chain on Hopper, the
// elementwise stage between the band-sum GEMM and the interpolation GEMM.
//
// Replaces the chain of small XLA ops after the band-sum product in
// frad_python_tpu/ops/psycho.py:mask_thres_mos_jnp and the threshold symbols
// of frad_python_tpu/models/batch.py:_p1_encode_jit / :_p2_encode_jit
// (about fourteen launches as eager PyTorch ops):
//
//   th[r, band] = band < nb ? max(sqrt(sums[r, band] * inv_w[band])^0.8,
//                                 aht[band]) * loss_level : 0
//   tq[b, band, c] = rint(sign(x) * |x|^(4/3)),
//                    x = log(max(th[r, band], 1)) / log(e/2),  r = b * C + c
//
// th keeps the row layout the interpolation GEMM reads; tq is written in the
// [B, 27, C] layout of the payload, so no transpose copy follows.
//
// Bound: a launch (37 k elements at 1,376 rows; 121 KB in, 297 KB out).
// Design: one thread per (row, band). Each step repeats the plain version's
// operation with one rounding (kernels/mask_thres.py:mask_thres_plain):
// products and the quotient are _rn intrinsics, the square root is the
// correctly rounded one, powf / pow take the exponent rounded to the compute
// type as torch.pow does with a Python float, log(e/2) is taken in the compute
// type here as the plain version takes it on the device, max and the clamp
// pass a NaN on as torch.maximum and torch.clamp do, rint rounds half to even.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUBBANDS = 27;

__device__ __forceinline__ float pow_t(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double pow_t(double a, double e) { return pow(a, e); }
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T, typename I>
__global__ void mask_thres_kernel(const T* __restrict__ sums, const T* __restrict__ inv_w,
                                  const T* __restrict__ aht, T* __restrict__ th_out,
                                  I* __restrict__ tq_out, int rows, int nbp, int nb, int C,
                                  T loss, T alpha, T exponent, T e_half) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)rows * SUBBANDS) return;
    const int band = (int)(i % SUBBANDS);
    const long long r = i / SUBBANDS;

    T th = (T)0;
    if (band < nb) {
        const T rms = pow_t(sqrt_rn(mul_rn(sums[r * nbp + band], inv_w[band])), alpha);
        const T floor = aht[band];
        const T m = rms != rms ? rms : (floor != floor ? floor : (rms < floor ? floor : rms));
        th = mul_rn(m, loss);
    }
    th_out[i] = th;

    const T clamped = th != th ? th : (th < (T)1 ? (T)1 : th);
    const T x = div_rn(log_t(clamped), log_t(e_half));
    const T sgn = (T)((x > (T)0) - (x < (T)0));
    const T y = rint_t(mul_rn(sgn, pow_t(abs_t(x), exponent)));
    tq_out[((r / C) * SUBBANDS + band) * C + (r % C)] = (I)y;
}

}  // namespace

extern "C" int frad_mask_thres(const void* sums, const void* inv_w, const void* aht, void* th,
                               void* tq, int rows, int nbp, int nb, int channels,
                               double loss_level, double alpha, double exponent, double e_half,
                               int is_f64, void* stream) {
    const long long n = (long long)rows * SUBBANDS;
    if (n <= 0) return 0;
    const int threads = 128;
    const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        mask_thres_kernel<double, long long><<<blocks, threads, 0, s>>>(
            (const double*)sums, (const double*)inv_w, (const double*)aht, (double*)th,
            (long long*)tq, rows, nbp, nb, channels, loss_level, alpha, exponent, e_half);
    else
        mask_thres_kernel<float, int><<<blocks, threads, 0, s>>>(
            (const float*)sums, (const float*)inv_w, (const float*)aht, (float*)th, (int*)tq,
            rows, nbp, nb, channels, (float)loss_level, (float)alpha, (float)exponent,
            (float)e_half);
    return (int)cudaGetLastError();
}
