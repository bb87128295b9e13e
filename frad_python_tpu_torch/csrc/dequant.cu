// dequant: the lossy decoders' dequantiser on Hopper, with Profile 1's
// threshold expansion folded in: symbols and threshold symbols to the
// IDCT's input in one launch.
//
// Replaces the pre-IDCT chain of the XLA device programs
// frad_python_tpu/models/batch.py:_p1_decode_jit (dequant, the threshold
// expansion with the interpolation GEMM of mapping_from_opus_jnp, the
// multiply) and the dequant of :_p2_decode_jit:
//
//   out[b, c, t] = sign(x) * |x|^(4/3) / factor * div[b, c, t],   x = symbols[b, t, c]
//   div[b, c, t] = th[lo] * w_lo + th[hi] * w_hi, 0 past band 25,
//   th[band]     = (e/2)^(sign(s) * sqrt(|s| * sqrt(|s|))),     s = thres[b, band, c]
//
// (thres_interp.cuh: the arithmetic of thres_expand.cu, which Profile 2
// still launches, since its TNS synthesis runs between the dequantiser and
// the multiply; Profile 2 passes no thresholds and gets the product
// without div). symbols are int16 (the exact upload of small EGR symbols,
// float32 compute) or the compute type, float32 or float64; the output is
// the IDCT GEMM's [B, C, N] layout, so the transpose is part of the kernel.
//
// The arithmetic repeats kernels/dequant.py:dequant_plain one rounding
// each: powf / pow with the exponent rounded to the compute type, as
// torch.pow does with a Python float; the sign as the float (x > 0) - (x <
// 0) times the power (a NaN symbol stays NaN, a zero gives +0); the scale
// as a product with 1 / factor, as torch divides a CUDA tensor by a Python
// number (the wrapper takes only the codec's factors, powers of two, whose
// reciprocal is exact: the same bits as a division); the divisor's two
// products and sum and the final product as _rn intrinsics, so nvcc forms
// no FMA.
//
// Bound: bytes, the symbols read and the output written once (17.1 MB at
// [689, 2048, 2] int16 with thresholds: 5.1 us at 3.35 TB/s), the divisor
// never stored. Design (each choice timed against its alternative on the
// card: tools/kernel_probe.py decode_variants, PERF.md):
// - A grid of (frame, chunk of bins); within a block indices are 32-bit
//   from one 64-bit frame base, and no integer division runs.
// - A thread owns one run of V = 16 / sizeof(T) bins and, for C = 1 or 2
//   (a template argument), all channels of them: its symbols are one
//   contiguous piece of the interleaved row, loaded as 16-byte (8 at int16
//   and C = 1) vectors, and each channel's V outputs are one 16-byte store.
//   Other channel counts, rows of N not a multiple of V and storage not
//   16-byte aligned take element-wise loads and stores in the same kernel.
//   One run a thread (8 symbols at C = 2): with two, a thread's symbols
//   queued behind each other and every float32 shape was slower.
// - powf (the correctly rounded log and exp of an IEEE power) bound the
//   first build: ~160 issued operations a symbol (16.7 us at [689]). So
//   each block tabulates k^(4/3) for k < POW_TABLE (256) with the same
//   powf / pow, one entry a thread, and a symbol whose magnitude is an
//   integer there reads its power from shared memory: the same bits. A run
//   reads all its table entries first and computes the powers the table
//   lacks under one branch (larger or non-integral magnitudes: rare), so
//   the common path is straight-line code.
// - With thresholds, warp 0 expands the frame's C x 27 thresholds into
//   shared memory and signals the other warps through a named barrier
//   (bar.arrive); meanwhile they issue the loads of their symbols and of
//   their runs' band and weight tables, build the table, wait for each
//   other alone (barrier 2) and compute the powers, so after bar.sync a
//   bin costs two shared loads and three operations for the divisor, and
//   the final product.

#include <type_traits>

#include "thres_interp.cuh"
#include "vec_io.cuh"

namespace {

using namespace thres;

// run threads a block at most (and warp 0 beside them with thresholds)
constexpr int MAX_RUNNERS = 256;
// integral magnitudes whose power a block tabulates: pw[k] = k^exponent
constexpr int POW_TABLE = 256;

__device__ __forceinline__ float trunc_t(float a) { return truncf(a); }
__device__ __forceinline__ double trunc_t(double a) { return trunc(a); }

// whether |x| = a has its power in the block's table: an integer under
// POW_TABLE (the table holds the same powf / pow of the same value: the
// same bits)
template <typename S, typename T>
__device__ __forceinline__ bool in_table(T a) {
    if constexpr (std::is_integral_v<S>)
        return a < (T)POW_TABLE;
    else
        return a < (T)POW_TABLE && a == trunc_t(a);
}

// sign(x) |x|^exponent * scale of K symbols: every table read first, then
// the computed powers of the magnitudes the table lacks under one branch,
// so that the common case is straight-line code whose reads overlap
template <typename S, typename T, int K>
__device__ __forceinline__ void scaled_powers(T (&y)[K], const S (&s)[K], const T* pw,
                                              T exponent, T scale) {
    bool all = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const T a = abs_t((T)s[k]);
        const bool in = in_table<S>(a);
        y[k] = pw[in ? (int)a : 0];
        all = all && in;
    }
    if (!all) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const T a = abs_t((T)s[k]);
            if (!in_table<S>(a)) y[k] = pow_t(a, exponent);
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const T x = (T)s[k];
        y[k] = mul_rn(mul_rn((T)((x > (T)0) - (x < (T)0)), y[k]), scale);
    }
}

// the run threads alone (named barrier 2; barrier 1 waits for warp 0)
__device__ __forceinline__ void runners_sync(int threads) {
    asm volatile("bar.sync 2, %0;" ::"r"(threads) : "memory");
}

// V outputs of one channel row at bin t0 (bins from `end` on dropped)
template <typename T, int V>
__device__ __forceinline__ void store_run(T* __restrict__ row, const T (&v)[V], int t0, int end,
                                          bool vec) {
    if (vec) {
        vio::store(row + t0, v);
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            if (t0 + j < end) row[t0 + j] = v[j];
    }
}

// CC: the channel count (1 or 2), or 0 for any (element-wise); DIV: with
// thresholds (Profile 1) or without (Profile 2)
template <typename S, typename T, int CC, bool DIV>
__global__ void __launch_bounds__(32 + MAX_RUNNERS)
dequant_kernel(const S* __restrict__ symbols, const T* __restrict__ thres,
               T* __restrict__ out, const uint8_t* __restrict__ band,
               const T* __restrict__ w_lo, const T* __restrict__ w_hi, int n, int channels,
               int chunk, T scale, T exponent, T e_half, int vec) {
    constexpr int V = Run<T>::V;
    extern __shared__ __align__(16) unsigned char smem[];
    T* th = reinterpret_cast<T*>(smem);                  // [C][27]
    __shared__ T pw[POW_TABLE];
    const int C = CC ? CC : channels;
    const int lead = DIV ? 32 : 0;
    const int d = (int)threadIdx.x - lead;
    const int nthr = (int)blockDim.x - lead;
    const int lo = (int)blockIdx.y * chunk;
    const int end = min(n, lo + chunk);
    const long long frame = (long long)blockIdx.x * n * C;
    const S* sym = symbols + frame;
    T* o = out + frame;
    if (DIV && d < 0) {
        if (threadIdx.x < SUBBANDS) {
            const T* tf = thres + (long long)blockIdx.x * SUBBANDS * C + threadIdx.x * C;
            if constexpr (CC > 0) {
                T t[CC];                                     // every load in one round trip
#pragma unroll
                for (int c = 0; c < CC; ++c) t[c] = tf[c];
#pragma unroll
                for (int c = 0; c < CC; ++c)
                    th[c * SUBBANDS + threadIdx.x] = expand_threshold(t[c], e_half);
            } else {
                for (int c = 0; c < C; ++c)
                    th[c * SUBBANDS + threadIdx.x] = expand_threshold(tf[c], e_half);
            }
        }
        bar_arrive((int)blockDim.x);
        return;
    }
    const int t0 = lo + V * d;                               // the thread's run
    const bool mine = t0 < end;
    Run<T> tab;
    if constexpr (CC > 0) {
        S s[V * CC];                                         // [j * CC + c]
        if (mine) {
            if (vec) {
                vio::load(s, sym + t0 * CC);
            } else {
#pragma unroll
                for (int k = 0; k < V * CC; ++k)
                    s[k] = t0 + k / CC < end ? sym[t0 * CC + k] : (S)0;
            }
            if (DIV) load_run(tab, band, w_lo, w_hi, t0, end, vec != 0);  // bands, weights
        }
        // the table while the loads fly, then the powers while warp 0 works
        // out the thresholds
#pragma unroll 1
        for (int k = d; k < POW_TABLE; k += nthr) pw[k] = pow_t((T)k, exponent);
        if (DIV)
            runners_sync(nthr);
        else
            __syncthreads();
        T y[V * CC];
        if (mine) scaled_powers(y, s, pw, exponent, scale);
        if (DIV) bar_sync((int)blockDim.x);
        if (!mine) return;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
            T v[V];
#pragma unroll
            for (int j = 0; j < V; ++j)
                v[j] = DIV ? mul_rn(y[j * CC + c], interp(th + c * SUBBANDS, tab, j))
                           : y[j * CC + c];
            store_run(o + c * n, v, t0, end, vec != 0);
        }
    } else {
#pragma unroll 1
        for (int k = d; k < POW_TABLE; k += nthr) pw[k] = pow_t((T)k, exponent);
        if (DIV) {
            if (mine) load_run(tab, band, w_lo, w_hi, t0, end, vec != 0);
            bar_sync((int)blockDim.x);
        } else {
            __syncthreads();
        }
        if (!mine) return;
        for (int c = 0; c < C; ++c) {
            S x[V];
#pragma unroll
            for (int j = 0; j < V; ++j) x[j] = t0 + j < end ? sym[(t0 + j) * C + c] : (S)0;
            T v[V];
            scaled_powers(v, x, pw, exponent, scale);
            if (DIV) {
#pragma unroll
                for (int j = 0; j < V; ++j)
                    v[j] = mul_rn(v[j], interp(th + c * SUBBANDS, tab, j));
            }
            store_run(o + c * n, v, t0, end, vec != 0);
        }
    }
}

template <typename S, typename T, bool DIV>
void launch(dim3 grid, int threads, size_t shared, cudaStream_t s, const void* symbols,
            const void* thres, void* out, const void* band, const void* w_lo, const void* w_hi,
            int n, int C, int chunk, double scale, double exponent, double e_half,
            int vec) {
    const S* sy = (const S*)symbols;
    const T* tq = (const T*)thres;
    const uint8_t* bd = (const uint8_t*)band;
    const T* lo = (const T*)w_lo;
    const T* hi = (const T*)w_hi;
    if (C == 1)
        dequant_kernel<S, T, 1, DIV><<<grid, threads, shared, s>>>(
            sy, tq, (T*)out, bd, lo, hi, n, C, chunk, (T)scale, (T)exponent,
            (T)e_half, vec);
    else if (C == 2)
        dequant_kernel<S, T, 2, DIV><<<grid, threads, shared, s>>>(
            sy, tq, (T*)out, bd, lo, hi, n, C, chunk, (T)scale, (T)exponent,
            (T)e_half, vec);
    else
        dequant_kernel<S, T, 0, DIV><<<grid, threads, shared, s>>>(
            sy, tq, (T*)out, bd, lo, hi, n, C, chunk, (T)scale, (T)exponent,
            (T)e_half, vec);
}

template <typename S, typename T>
void launch_kind(bool div, dim3 grid, int threads, size_t shared, cudaStream_t s,
                 const void* symbols, const void* thres, void* out, const void* band,
                 const void* w_lo, const void* w_hi, int n, int C, int chunk, double scale,
                 double exponent, double e_half, int vec) {
    if (div)
        launch<S, T, true>(grid, threads, shared, s, symbols, thres, out, band, w_lo, w_hi, n,
                           C, chunk, scale, exponent, e_half, vec);
    else
        launch<S, T, false>(grid, threads, shared, s, symbols, thres, out, band, w_lo, w_hi,
                            n, C, chunk, scale, exponent, e_half, vec);
}

bool aligned(const void* p, uintptr_t a) { return p == nullptr || (uintptr_t)p % a == 0; }

}  // namespace

// symbols [B, N, C]; thres [B, 27, C] in the compute type, or null for the
// product without a divisor (then band, w_lo, w_hi are unused); band [N]
// (uint8), w_lo and w_hi [N] (compute type) are device tables
// (ops/psycho.py:device_consts); out [B, C, N]; `scale` is 1 / factor.
// sym_kind: 0 int16 symbols (float32 compute), 1 float32, 2 float64.
extern "C" int frad_dequant(const void* symbols, const void* thres, void* out, int B, int N,
                            int C, const void* band, const void* w_lo, const void* w_hi,
                            double scale, double exponent, double e_half, int sym_kind,
                            void* stream) {
    if ((long long)B * C * N <= 0) return 0;
    const int V = sym_kind == 2 ? 2 : 4;
    const int runs = (N + V - 1) / V;
    const int nthr = min(MAX_RUNNERS, (runs + 31) / 32 * 32);
    const int chunk = V * nthr;
    const dim3 grid((unsigned int)B, (unsigned int)((N + chunk - 1) / chunk));
    const bool div = thres != nullptr;
    const int threads = (div ? 32 : 0) + nthr;
    const size_t shared = div ? (size_t)C * 27 * (sym_kind == 2 ? 8 : 4) : 0;
    const int vec = N % V == 0 && aligned(symbols, 16) && aligned(out, 16) && aligned(w_lo, 16)
                    && aligned(w_hi, 16) && aligned(band, 4);
    cudaStream_t s = (cudaStream_t)stream;
    if (sym_kind == 0)
        launch_kind<int16_t, float>(div, grid, threads, shared, s, symbols, thres, out, band,
                                    w_lo, w_hi, N, C, chunk, scale, exponent, e_half,
                                    vec);
    else if (sym_kind == 1)
        launch_kind<float, float>(div, grid, threads, shared, s, symbols, thres, out, band,
                                  w_lo, w_hi, N, C, chunk, scale, exponent, e_half, vec);
    else
        launch_kind<double, double>(div, grid, threads, shared, s, symbols, thres, out, band,
                                    w_lo, w_hi, N, C, chunk, scale, exponent, e_half,
                                    vec);
    return (int)cudaGetLastError();
}
