// mask_thres: the lossy encoders' masking chain on Hopper, from the DCT's
// spectra to the per-bin divisor and the threshold symbols in one launch.
//
// Replaces the masking part of the XLA device programs
// frad_python_tpu/models/batch.py:_p1_encode_jit and :_p2_encode_jit:
// frad_python_tpu/ops/psycho.py:mask_thres_mos_jnp of |freqs| * factor (a
// band-sum GEMM), mapping_from_opus_jnp (an interpolation GEMM) and the
// threshold symbols. Per row r of freqs [R, N]:
//
//   a = |x| * factor, s = a * a                         (two roundings)
//   sum[band]  = the band's s in the order below, for the nb active bands
//   th[band]   = band < nb ? max(sqrt(sum * inv_w)^0.8, aht) * loss : 0
//   tq[b, band, c] = rint(sign(y) * |y|^(4/3)), y = log(max(th, 1)) / log(e/2),
//                    r = b * C + c
//   div[r, t]  = th[lo] * w_lo + th[hi] * w_hi, 0 past band 25 (thres_interp.cuh)
//
// The order of a band sum (kernels/mask_thres.py:band_sums_plain): one warp
// owns the band; lane l adds the band's bins l, l + 32, ... in ascending
// order from +0, then the warp adds its lanes as a shuffle tree (s = 16, 8,
// 4, 2, 1). The threshold chain and the symbols are those of the kernel
// this one replaced, operation for operation (powf / pow with the exponent
// rounded to the compute type as torch.pow takes a Python float, max and the
// clamp passing a NaN on as torch.maximum and torch.clamp do, rint half to
// even).
//
// Bound: bytes, the row read once and the divisor written once (11.3 MB each
// way at [1376, 2048] float32: 6.7 us at 3.35 TB/s); at the streaming
// engines' 8 rows, the launch and one round trip to memory for the row.
// Design:
// - One block a row. Warp w owns the bands w, w + W, ... (W warps); it
//   issues a band's loads S steps of 32 bins at a time before it adds any,
//   so a band of up to 32 * S bins costs it one round trip to memory. With
//   32 warps a row (kernels/mask_thres.py:geometry, few rows) each warp owns
//   one band at most, and the row costs one round trip; with 8 (many rows,
//   several blocks an SM) a warp's two or three bands cost it as many. The
//   row is never held in shared memory, so any N works.
// - The band starts, 1/width and the AHT floor come by value (param space:
//   a band's start is one uniform load); the divisor's per-bin tables come
//   from device memory, the first run of each thread loaded before the band
//   sums, so their latency hides under the row's.
// - The band sums go through shared memory. Warp 0 then works out the 27
//   thresholds, signals the other warps through a named barrier without
//   waiting (bar.arrive), and writes the symbols while they write the
//   divisor with 16-byte stores.
// - Tried and gone (times in PERF.md): each row split over a cluster of 2 or 4
//   blocks, the band sums read through distributed shared memory (no faster
//   at 8 rows, slower at 1376); a warp loading its next band's first steps
//   before adding the current one's (slower at 1376 rows, and float64
//   spilled).

#include "thres_interp.cuh"

// clock64() stamps of a probe build (tools/kernel_probe.py); none here
#ifndef PHASE_STAMP
#define PHASE_STAMP(k)
#endif

namespace {

using namespace thres;

// steps of 32 bins a warp loads before it adds them
constexpr int S = 16;

// the band tables, by value: starts, and 1/width and the AHT floor rounded
// to the compute type
template <typename T>
struct Bands {
    int st[SUBBANDS + 1];
    T inv_w[SUBBANDS];
    T aht[SUBBANDS];
};

template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, s));
    return v;
}

// S steps of a band's bins from k0 on (0 past its end `hi`)
template <typename T>
__device__ __forceinline__ void load_steps(T (&v)[S], const T* __restrict__ row, int k0,
                                           int hi, int lane) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int t = k0 + 32 * s + lane;
        v[s] = t < hi ? row[t] : (T)0;
    }
}

// the squares of those steps added to the lane's running sum, in order
template <typename T>
__device__ __forceinline__ void add_steps(T& acc, const T (&v)[S], int k0, int hi, int lane,
                                          T factor) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
        if (k0 + 32 * s < hi) {                  // a step of the band: the same in every lane
            const T a = mul_rn(abs_t(v[s]), factor);
            acc = add_rn(acc, k0 + 32 * s + lane < hi ? mul_rn(a, a) : (T)0);
        }
    }
}

// the sums of the warp's bands g, g + nw, ... of `row`, lane 0 writing each
// into sums[band]
template <typename T>
__device__ __forceinline__ void band_sums(const T* __restrict__ row,
                                          const int (&st)[SUBBANDS + 1], int nb, T factor,
                                          int g, int nw, T* sums) {
    const int lane = threadIdx.x & 31;
    for (int b = g; b < nb; b += nw) {
        const int lo = st[b], hi = st[b + 1];
        T acc = (T)0;
        for (int k0 = lo; k0 < hi; k0 += 32 * S) {
            T v[S];
            load_steps(v, row, k0, hi, lane);
            add_steps(acc, v, k0, hi, lane, factor);
        }
        acc = warp_tree(acc);
        if (lane == 0) sums[b] = acc;
    }
}

template <typename T, typename I>
__global__ void __launch_bounds__(1024)
mask_thres_kernel(const T* __restrict__ freqs, T* __restrict__ div, I* __restrict__ tq,
                  const __grid_constant__ Bands<T> bands, const uint8_t* __restrict__ band,
                  const T* __restrict__ w_lo, const T* __restrict__ w_hi, int n, int C, int nb,
                  T factor, T loss, T alpha, T exponent, T e_half, int vec) {
    __shared__ T sums[SUBBANDS];
    __shared__ T th[SUBBANDS];
    const int r = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthr = (int)blockDim.x - 32;    // the divisor's threads: warps 1, 2, ...
    PHASE_STAMP(0);
    T inv_w = (T)0, floor = (T)0;
    Divisor<T, 1> out;
    if (tid < SUBBANDS) {
        inv_w = bands.inv_w[tid];
        floor = bands.aht[tid];
    } else if (tid >= 32) {
        out.prefetch(band, w_lo, w_hi, 0, n, tid - 32, nthr, vec != 0);
    }
    band_sums(freqs + (long long)r * n, bands.st, nb, factor, tid >> 5, (int)blockDim.x >> 5,
              sums);
    PHASE_STAMP(1);
    __syncthreads();
    PHASE_STAMP(2);

    if (tid < 32) {
        T t = (T)0;
        if (tid < nb) {
            const T rms = pow_t(sqrt_rn(mul_rn(sums[tid], inv_w)), alpha);
            const T m = rms != rms ? rms : (floor != floor ? floor : (rms < floor ? floor : rms));
            t = mul_rn(m, loss);
        }
        if (tid < SUBBANDS) th[tid] = t;
        bar_arrive((int)blockDim.x);
        PHASE_STAMP(3);
        if (tid < SUBBANDS) {
            const T clamped = t != t ? t : (t < (T)1 ? (T)1 : t);
            const T y = div_rn(log_t(clamped), log_t(e_half));
            const T sgn = (T)((y > (T)0) - (y < (T)0));
            tq[((r / C) * SUBBANDS + tid) * C + (r % C)] =
                (I)rint_t(mul_rn(sgn, pow_t(abs_t(y), exponent)));
        }
        PHASE_STAMP(4);
    } else {
        bar_sync((int)blockDim.x);
        out.write(div + (long long)r * n, th, band, w_lo, w_hi, 0, n, tid - 32, nthr, vec != 0);
        PHASE_STAMP(5);
    }
}

template <typename T, typename I>
int launch(const void* freqs, void* div, void* tq, int rows, int n, int C, const int* starts,
           const double* inv_w, const double* aht, int nb, const void* band, const void* w_lo,
           const void* w_hi, double factor, double loss, double alpha, double exponent,
           double e_half, int threads, cudaStream_t stream) {
    Bands<T> bands;
    for (int i = 0; i <= SUBBANDS; ++i) bands.st[i] = starts[i];
    for (int i = 0; i < SUBBANDS; ++i) {
        bands.inv_w[i] = (T)inv_w[i];
        bands.aht[i] = (T)aht[i];
    }
    constexpr int V = 16 / sizeof(T);
    const int vec = n % V == 0 && (uintptr_t)div % 16 == 0;
    mask_thres_kernel<T, I><<<(unsigned int)rows, threads, 0, stream>>>(
        (const T*)freqs, (T*)div, (I*)tq, bands, (const uint8_t*)band, (const T*)w_lo,
        (const T*)w_hi, n, C, nb, (T)factor, (T)loss, (T)alpha, (T)exponent, (T)e_half, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// starts [28], inv_w [27] and aht [27] are host arrays (ops/psycho.py:
// kernel_tables); band [n] (uint8), w_lo and w_hi [n] (compute type) device
// tables (ops/psycho.py:device_consts); threads (a block, 64 to 1024) come
// from kernels/mask_thres.py:geometry, and any value gives the same bits.
extern "C" int frad_mask_thres(const void* freqs, void* div, void* tq, int rows, int n,
                               int channels, const int* starts, const double* inv_w,
                               const double* aht, int nb, const void* band, const void* w_lo,
                               const void* w_hi, double factor, double loss_level, double alpha,
                               double exponent, double e_half, int is_f64, int threads,
                               void* stream) {
    if (rows <= 0) return 0;
    if (threads < 64 || threads > 1024 || threads % 32 != 0 || n < 1 || nb < 0
        || nb > SUBBANDS || channels < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        return launch<double, long long>(freqs, div, tq, rows, n, channels, starts, inv_w, aht,
                                         nb, band, w_lo, w_hi, factor, loss_level, alpha,
                                         exponent, e_half, threads, s);
    return launch<float, int>(freqs, div, tq, rows, n, channels, starts, inv_w, aht, nb, band,
                              w_lo, w_hi, factor, loss_level, alpha, exponent, e_half, threads,
                              s);
}
