// The masking kernels' shared pieces: IEEE-rounded operations by type, the
// decoders' threshold expansion, and the two-term interpolation of a row's
// 27 thresholds to its per-bin divisor (mask_thres.cu, thres_expand.cu and
// dequant.cu).
//
// The interpolation repeats kernels/mask_thres.py:interpolate_plain:
//   div[t] = th[b] * w_lo[t] + th[b + 1] * w_hi[t]   for a valid bin t of band b
//   div[t] = 0                                        past band 25
// two _rn products and one _rn sum, so nvcc forms no FMA. The kernels read
// the plain version's own tables (ops/psycho.py:device_consts): the band of
// each bin as a byte (255 past band 25) and the two weights in the compute
// type, which are the entries of the JAX package's interpolation matrix
// rounded to it. The tables are the same for every row, so after the first
// block of an SM they come from its L1.
//
// A row's bins are written in runs of 16 bytes (4 float32 or 2 float64
// bins) by the block's divisor threads; the first runs' tables are loaded
// before the thresholds are known (`Divisor::prefetch`), so after the
// barrier a run costs two shared loads a bin, the arithmetic and one
// 16-byte store.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace thres {

constexpr int SUBBANDS = 27;
// the band byte of a bin past band 25
constexpr uint8_t NO_BAND = 255;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float pow_t(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double pow_t(double a, double e) { return pow(a, e); }
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }

// bar.arrive / bar.sync on named barrier 1: a producer warp signals and goes
// on, the consumer warps wait (with release / acquire of shared memory)
__device__ __forceinline__ void bar_arrive(int threads) {
    asm volatile("bar.arrive 1, %0;" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int threads) {
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// one run of V = 16 / sizeof(T) bins: their bands and weights
template <typename T>
struct Run {
    static constexpr int V = 16 / sizeof(T);
    uint8_t b[V];
    T lo[V], hi[V];
};

// the tables of the run at bin t0 (bins past `end` marked NO_BAND); `vec`:
// whole 16-byte pieces (the row a whole number of runs, the output aligned)
template <typename T>
__device__ __forceinline__ void load_run(Run<T>& run, const uint8_t* __restrict__ band,
                                         const T* __restrict__ w_lo,
                                         const T* __restrict__ w_hi, int t0, int end,
                                         bool vec) {
    constexpr int V = Run<T>::V;
    if (vec) {
        if constexpr (V == 4) {
            const uchar4 b = __ldg(reinterpret_cast<const uchar4*>(band + t0));
            const float4 l = __ldg(reinterpret_cast<const float4*>(w_lo + t0));
            const float4 h = __ldg(reinterpret_cast<const float4*>(w_hi + t0));
            run.b[0] = b.x; run.b[1] = b.y; run.b[2] = b.z; run.b[3] = b.w;
            run.lo[0] = l.x; run.lo[1] = l.y; run.lo[2] = l.z; run.lo[3] = l.w;
            run.hi[0] = h.x; run.hi[1] = h.y; run.hi[2] = h.z; run.hi[3] = h.w;
        } else {
            const uchar2 b = __ldg(reinterpret_cast<const uchar2*>(band + t0));
            const double2 l = __ldg(reinterpret_cast<const double2*>(w_lo + t0));
            const double2 h = __ldg(reinterpret_cast<const double2*>(w_hi + t0));
            run.b[0] = b.x; run.b[1] = b.y;
            run.lo[0] = l.x; run.lo[1] = l.y;
            run.hi[0] = h.x; run.hi[1] = h.y;
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const bool in = t0 + j < end;
            run.b[j] = in ? __ldg(band + t0 + j) : NO_BAND;
            run.lo[j] = in ? __ldg(w_lo + t0 + j) : (T)0;
            run.hi[j] = in ? __ldg(w_hi + t0 + j) : (T)0;
        }
    }
}

// the divisor of bin j of a run from the row's thresholds th[27]
template <typename T>
__device__ __forceinline__ T interp(const T* th, const Run<T>& run, int j) {
    const int b = run.b[j];
    return b == NO_BAND ? (T)0 : add_rn(mul_rn(th[b], run.lo[j]), mul_rn(th[b + 1], run.hi[j]));
}

// one decoded threshold (e/2)^(sign(t) * sqrt(|t| * sqrt(|t|))) of symbol t,
// as kernels/thres_expand.py:expand_plain computes it
template <typename T>
__device__ __forceinline__ T expand_threshold(T t, T e_half) {
    const T a = abs_t(t);
    const T sgn = (T)((t > (T)0) - (t < (T)0));
    return pow_t(e_half, mul_rn(sgn, sqrt_rn(mul_rn(a, sqrt_rn(a)))));
}

// the run's divisors from the row's thresholds th[27] (shared memory)
template <typename T>
__device__ __forceinline__ void write_run(T* __restrict__ out, const T* th, const Run<T>& run,
                                          int t0, int end, bool vec) {
    constexpr int V = Run<T>::V;
    T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = interp(th, run, j);
    if (vec) {
        if constexpr (V == 4)
            reinterpret_cast<float4*>(out + t0)[0] = make_float4(v[0], v[1], v[2], v[3]);
        else
            reinterpret_cast<double2*>(out + t0)[0] = make_double2(v[0], v[1]);
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            if (t0 + j < end) out[t0 + j] = v[j];
    }
}

// bins [lo, end) of one row's divisor, written by `nthr` threads (this one
// is number d) in runs; the first P runs of each thread are prefetched
template <typename T, int P>
struct Divisor {
    static constexpr int V = Run<T>::V;
    Run<T> pre[P];

    __device__ __forceinline__ void prefetch(const uint8_t* band, const T* w_lo, const T* w_hi,
                                             int lo, int end, int d, int nthr, bool vec) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int t0 = lo + V * (d + p * nthr);
            if (t0 < end) load_run(pre[p], band, w_lo, w_hi, t0, end, vec);
        }
    }

    __device__ __forceinline__ void write(T* out, const T* th, const uint8_t* band,
                                          const T* w_lo, const T* w_hi, int lo, int end, int d,
                                          int nthr, bool vec) const {
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int t0 = lo + V * (d + p * nthr);
            if (t0 < end) write_run(out, th, pre[p], t0, end, vec);
        }
        for (int t0 = lo + V * (d + P * nthr); t0 < end; t0 += V * nthr) {
            Run<T> run;
            load_run(run, band, w_lo, w_hi, t0, end, vec);
            write_run(out, th, run, t0, end, vec);
        }
    }
};

}  // namespace thres
