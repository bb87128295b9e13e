// thres_expand: the lossy decoders' threshold chain on Hopper, from the
// threshold symbols to the per-bin divisor in one launch.
//
// Replaces the head of the XLA device programs
// frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit:
// `(e/2) ** quant_jnp(thres)` and the interpolation GEMM of
// frad_python_tpu/ops/psycho.py:mapping_from_opus_jnp. Per row (b, c):
//
//   th[band] = (e/2)^(sign(t) * sqrt(|t| * sqrt(|t|))),  t = thres[b, band, c]
//   div[b, c, t] = th[lo] * w_lo + th[hi] * w_hi, 0 past band 25
//                  (thres_interp.cuh, the same form as mask_thres's divisor)
//
// The arithmetic repeats kernels/thres_expand.py:thres_expand_plain one
// rounding each: both square roots correctly rounded, the product an _rn
// intrinsic, the sign as (t > 0) - (t < 0) times the root (0 stays +0, a NaN
// stays NaN), powf / pow with the base e/2 rounded to the compute type as the
// plain version's 0-dim tensor holds it.
//
// Bound: bytes, the divisor written once (11.3 MB at [689, 2, 2048] float32:
// 3.4 us at 3.35 TB/s; the symbols are 149 KB). Design: a grid over (row,
// chunk of bins); warp 0 of each block expands its row's 27 thresholds
// into shared memory and signals the other warps through a named barrier
// (bar.arrive); they have loaded their runs' tables meanwhile, and each
// writes RUNS runs of the chunk with 16-byte stores (the wrapper picks the
// threads so that a 2048-bin row is one block).

#include "thres_interp.cuh"

namespace {

using namespace thres;

// runs of 16 bytes a divisor thread writes in a block's chunk
constexpr int RUNS = 2;

template <typename T>
__global__ void __launch_bounds__(1024)
thres_expand_kernel(const T* __restrict__ thres, T* __restrict__ out,
                    const uint8_t* __restrict__ band, const T* __restrict__ w_lo,
                    const T* __restrict__ w_hi, int C, int n, int chunks, T e_half, int vec) {
    __shared__ T th[SUBBANDS];
    const long long row = blockIdx.x / chunks;
    const int part = (int)(blockIdx.x - row * chunks);
    const int tid = threadIdx.x;
    const int nthr = (int)blockDim.x - 32;
    constexpr int V = Run<T>::V;
    const int lo = part * RUNS * V * nthr;
    const int end = min(n, lo + RUNS * V * nthr);
    if (tid < 32) {
        if (tid < SUBBANDS) {
            const long long b = row / C;
            const int c = (int)(row - b * C);
            const T t = thres[(b * SUBBANDS + tid) * C + c];
            const T a = abs_t(t);
            const T sgn = (T)((t > (T)0) - (t < (T)0));
            th[tid] = pow_t(e_half, mul_rn(sgn, sqrt_rn(mul_rn(a, sqrt_rn(a)))));
        }
        bar_arrive((int)blockDim.x);
    } else {
        Divisor<T, RUNS> div;
        div.prefetch(band, w_lo, w_hi, lo, end, tid - 32, nthr, vec != 0);
        bar_sync((int)blockDim.x);
        div.write(out + row * n, th, band, w_lo, w_hi, lo, end, tid - 32, nthr, vec != 0);
    }
}

}  // namespace

// band [n] (uint8), w_lo and w_hi [n] (compute type) are device tables
// (ops/psycho.py:device_consts). A block has 32 + 32k threads (64 to 1024):
// enough divisor threads for RUNS runs each to cover a row, at most 992.
extern "C" int frad_thres_expand(const void* thres, void* out, int B, int C, int n,
                                 const void* band, const void* w_lo, const void* w_hi,
                                 double e_half, int is_f64, void* stream) {
    if ((long long)B * C <= 0) return 0;
    if (n < 1) return (int)cudaErrorInvalidValue;
    const int V = is_f64 ? 2 : 4;
    const int runs = (n + V - 1) / V;
    const int nthr = min(992, ((runs + RUNS - 1) / RUNS + 31) / 32 * 32);
    const int chunks = (n + RUNS * V * nthr - 1) / (RUNS * V * nthr);
    const unsigned int blocks = (unsigned int)((long long)B * C * chunks);
    const int vec = n % V == 0 && (uintptr_t)out % 16 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        thres_expand_kernel<double><<<blocks, 32 + nthr, 0, s>>>(
            (const double*)thres, (double*)out, (const uint8_t*)band, (const double*)w_lo,
            (const double*)w_hi, C, n, chunks, e_half, vec);
    else
        thres_expand_kernel<float><<<blocks, 32 + nthr, 0, s>>>(
            (const float*)thres, (float*)out, (const uint8_t*)band, (const float*)w_lo,
            (const float*)w_hi, C, n, chunks, (float)e_half, vec);
    return (int)cudaGetLastError();
}
