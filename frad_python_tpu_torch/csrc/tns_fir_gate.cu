// tns_fir_gate: the back of Profile 2's TNS analysis on Hopper, with the
// Levinson recursion in front of it.
//
// Replaces the XLA device programs `_levinson`, `_quantise`, `_dequantise`,
// `_fir`, `_predgain` and the gates and selects of `tns_analysis` in
// frad_python_tpu/ops/tns_jax.py. Per row (one lane) of N values, with the
// autocorrelation ac [13] and the gate of tns_autocorr:
//
//   lpc  = levinson(ac)                                        (tns_levinson.cuh)
//   run  = gate and |lpc[1]| + ... + |lpc[12]| >= 0.01        (j ascending)
//   q[j] = rint(clip(15 * lpc[j], -15, 14)), q[0] = 0;  run &= some q != 0
//   c    = q / 15, c[0] = 1
//   r[t] = c[0] x[t] + c[1] x[t-1] + ... + c[12] x[t-12]      (j ascending, x[<0] = +0)
//   run &= r finite and max |r| <= 1e6
//   oe = sum (x - mean x)^2, re = sum (r - mean r)^2
//   run &= not (oe < 1e-10 or re < 1e-10 or re >= oe)
//          and 20 log10(re == 0 ? 1 : oe / re) >= log10(2) / 10
//   out = run ? r : x;  lpc_out = run ? q : 0
//
// Bound: bytes (a row read once and written once: 22.6 MB at 1,378 rows of
// 2048 float32); at the streaming engines' 8 rows, the launch, one round
// trip to memory and the row's chain of phases. Design: a block of 256
// threads a row, four barriers.
// - The row reaches shared memory in one round: every thread issues its
//   16-byte cp.async copies (element-wise ones where the row is not 16-byte
//   aligned) before anything waits on them, and while they are in flight
//   thread 0 loads the row's gate and 13 lags and, for a row whose gate is
//   true, runs the recursion; lanes 1..12 of its warp then quantise a
//   coefficient each and write c and q to shared memory. The barrier that
//   ends the load publishes them. A row whose gate is false,
//   or whose coefficients fail their gates, copies x out of shared memory
//   with 16-byte stores and stops there.
// - The FIR is tiled in registers: a thread computes runs of 4 consecutive
//   outputs (two at 2048 samples), each from the 16 values it reads from
//   shared memory once (16-byte loads; x[-12..-1] is a pad of +0), each
//   output c0 x[t] then + c[j] x[t-j] for j = 1..12 in order, and writes
//   them to shared memory beside x. The tiles' max |r| and finite flag stay
//   in registers.
// - The four sums follow the order fixed in tns_reduce.cuh (owner t adds
//   elements t, t + 256, ... from +0, then warp_sums / tree_sum); they read
//   x and r from shared memory. The sums of x and r share one warp round
//   and one barrier with the max and the finite flag; the centred energies
//   are the second round.
// - The output pass writes r (or x) from shared memory with 16-byte stores.
// - At N = 2048, the codec's frames, the steps are a compile-time 8 and
//   every mask folds away; other lengths count them at run time. A row too
//   long for x and r both in shared memory (float64 above ~14,400 samples)
//   keeps r in `out` instead.
// Every operation is one IEEE rounding, so the kernel is bit-identical to
// kernels/tns_fir_gate.py:tns_fir_gate_plain; a NaN or infinite residual
// fails the finite test and never reaches the maximum (fmax drops a NaN); a
// bypassed row returns the input's bits.
// - Registers: 40 at float32 under the hint of 6 blocks an SM (no spill at
//   2048 samples; 1,378 rows take 1.7 waves), 77 at float64 under a hint of
//   3 (2 blocks without it). Runs of 8 outputs, 512
//   threads a row (two threads an owner of the sums) and other hints were
//   timed slower (tools/kernel_probe.py fir_gate_variants; PERF.md).
// PHASE_STAMP marks the phases for tools/kernel_probe.py, which defines it in
// a build of its own (FIR_TILE and FIR_MIN_BLOCKS_F32 / _F64 likewise pick
// the variants it times); the package's build leaves it empty.

#include <stdint.h>

#include "tns_levinson.cuh"

#ifndef PHASE_STAMP
#define PHASE_STAMP(k)
#endif
#ifndef FIR_TILE
#define FIR_TILE 4
#endif
#ifndef FIR_MIN_BLOCKS_F32
#define FIR_MIN_BLOCKS_F32 6
#endif
#ifndef FIR_MIN_BLOCKS_F64
#define FIR_MIN_BLOCKS_F64 3
#endif

namespace {

using namespace tns;

constexpr int NT = SUM_T;                // threads a row: one an owner of the sums
constexpr int R = FIR_TILE;              // outputs of a thread's tile
constexpr int HALO = ORDER1 - 1;         // values before a tile that its outputs read
constexpr int PAD = 16;                  // +0 values in front of the row
// shared values besides x and r: c, q and the raw LPC, the sums, the
// energies, the warps' maxima, their finite flags and the go flag (as ints)
constexpr int EXTRA = PAD + 48 + 6 * WARPS + 1;
constexpr size_t SMEM_LIMIT = 232448 - 64;
constexpr double MIN_PRED = 0.030102999566398118;   // log10(2) / 10
static_assert(R % 4 == 0, "a tile is whole 16-byte pieces");

__device__ __forceinline__ void unpack(const uint4& u, float* w) {
    w[0] = __uint_as_float(u.x);
    w[1] = __uint_as_float(u.y);
    w[2] = __uint_as_float(u.z);
    w[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, double* w) {
    w[0] = __hiloint2double((int)u.y, (int)u.x);
    w[1] = __hiloint2double((int)u.w, (int)u.z);
}
__device__ __forceinline__ uint4 pack(const float* w) {
    return make_uint4(__float_as_uint(w[0]), __float_as_uint(w[1]), __float_as_uint(w[2]),
                      __float_as_uint(w[3]));
}
__device__ __forceinline__ uint4 pack(const double* w) {
    return make_uint4((unsigned)__double2loint(w[0]), (unsigned)__double2hiint(w[0]),
                      (unsigned)__double2loint(w[1]), (unsigned)__double2hiint(w[1]));
}

// cp.async of B bytes (4, 8 or 16) from global to shared memory
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (B == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B)
                     : "memory");
}

// n values from 16-byte aligned shared memory to `out`: 16-byte stores where
// `out` is 16-byte aligned, the rest value by value
template <typename T>
__device__ __forceinline__ void write_row(const T* src, T* out, int n) {
    constexpr int V = 16 / sizeof(T);
    const int nv = ((uintptr_t)out & 15) == 0 ? n / V : 0;
    for (int v = threadIdx.x; v < nv; v += NT)
        reinterpret_cast<uint4*>(out)[v] = reinterpret_cast<const uint4*>(src)[v];
    for (int i = nv * V + threadIdx.x; i < n; i += NT) out[i] = src[i];
}

// lpc_out and run of a row: q where TNS runs (q != null), else zeros
template <typename T>
__device__ __forceinline__ void finish(const T* q, T* lpc_out, uint8_t* run_out) {
    if (threadIdx.x < ORDER1) lpc_out[threadIdx.x] = q != nullptr ? q[threadIdx.x] : (T)0;
    if (threadIdx.x == 0) *run_out = q != nullptr;
}

// A block a row; N > 0 is the row's length known at compile time.
template <typename T, int N>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? FIR_MIN_BLOCKS_F32 : FIR_MIN_BLOCKS_F64)
tns_fir_gate_kernel(const T* __restrict__ x_in, const T* __restrict__ ac_in,
                    const uint8_t* __restrict__ gate_in, T* __restrict__ out_all,
                    T* __restrict__ lpc_out_all, uint8_t* __restrict__ run_all, int n_rt,
                    bool resid_global) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int V = 16 / sizeof(T);
    const int n = N > 0 ? N : n_rt;
    const int n8 = (n + 7) & ~7;
    const bool r_out = N == 0 && resid_global;          // r lives in `out`
    T* const xs = reinterpret_cast<T*>(smem_raw) + PAD;
    T* const coef = xs + (r_out ? n8 : 2 * n8);          // c[0..12], q[16..28]
    T* const lpc_s = coef + 32;                          // the raw LPC [13]
    T* const sc_sum = coef + 48;
    T* const sc_en = sc_sum + 2 * WARPS;
    T* const sc_peak = sc_en + 2 * WARPS;
    int* const fin_w = reinterpret_cast<int*>(sc_peak + WARPS);   // WARPS flags, then go
    const int tid = threadIdx.x;
    const long long lane = blockIdx.x;
    const T* const x = x_in + lane * n;
    T* const out = out_all + lane * n;
    T* const rs = r_out ? out : xs + n8;
    T* const lpc_out = lpc_out_all + lane * ORDER1;
    uint8_t* const run_out = run_all + lane;
    const T scale = (T)15;

    // load: the row into shared memory, every copy issued before any wait;
    // meanwhile thread 0 works out the coefficients
    PHASE_STAMP(0);
    if (tid < PAD) xs[tid - PAD] = (T)0;
    const int nv = ((uintptr_t)x & 15) == 0 ? n / V : 0;
    for (int v = tid; v < nv; v += NT) cp_async<16>(xs + v * V, x + v * V);
    for (int i = nv * V + tid; i < n; i += NT) cp_async<sizeof(T)>(xs + i, x + i);
    if (tid < 32) {
        // warp 0: lane 0 runs the recursion and sums |lpc|, then lanes 1..12
        // quantise a coefficient each
        T total = (T)0;
        int g = 0;
        if (tid == 0) {
            T ac[ORDER1];
#pragma unroll
            for (int j = 0; j < ORDER1; ++j) ac[j] = ac_in[lane * ORDER1 + j];
            g = gate_in[lane] != 0;
            if (g) {
                T lpc[ORDER1];
                levinson(ac, lpc);
                total = abs_t(lpc[1]);
#pragma unroll
                for (int j = 2; j < ORDER1; ++j) total = add_rn(total, abs_t(lpc[j]));
#pragma unroll
                for (int j = 1; j < ORDER1; ++j) lpc_s[j] = lpc[j];
            }
        }
        g = __shfl_sync(0xffffffffu, g, 0);
        PHASE_STAMP(1);
        int ok = 0;
        if (g) {
            __syncwarp();
            T q = (T)0;
            if (tid >= 1 && tid < ORDER1) {
                const T v = mul_rn(lpc_s[tid], scale);
                const T clipped =
                    v != v ? v : (v < -scale ? -scale : (v > scale - (T)1 ? scale - (T)1 : v));
                q = rint_t(clipped);
                coef[16 + tid] = q;
                coef[tid] = div_rn(q, scale);
            }
            const bool any = __any_sync(0xffffffffu, q != (T)0);
            if (tid == 0) {
                coef[0] = (T)1;
                coef[16] = (T)0;
                ok = total >= (T)0.01 && any;
            }
        }
        if (tid == 0) fin_w[WARPS] = ok;
        PHASE_STAMP(2);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    PHASE_STAMP(3);
    if (!fin_w[WARPS]) {
        write_row(xs, out, n);
        finish<T>(nullptr, lpc_out, run_out);
        return;
    }

    // FIR: a thread's tiles of R outputs into r; their max |r| and finite flag
    T c[ORDER1];
#pragma unroll
    for (int j = 0; j < ORDER1; ++j) c[j] = coef[j];
    T peak = (T)0;
    bool fin = true;
    for (int t0 = R * tid; t0 < n; t0 += R * NT) {
        T w[HALO + R];
#pragma unroll
        for (int v = 0; v < (HALO + R) / V; ++v)
            unpack(reinterpret_cast<const uint4*>(xs + t0 - HALO)[v], w + v * V);
        T y[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            y[k] = mul_rn(c[0], w[HALO + k]);
#pragma unroll
            for (int j = 1; j < ORDER1; ++j) y[k] = add_rn(y[k], mul_rn(c[j], w[HALO + k - j]));
            if (N > 0 || t0 + k < n) {
                peak = max_t(peak, abs_t(y[k]));
                fin = fin && isfinite(y[k]);
            }
        }
        if (r_out) {
#pragma unroll
            for (int k = 0; k < R; ++k)
                if (t0 + k < n) rs[t0 + k] = y[k];
        } else {
#pragma unroll
            for (int v = 0; v < R / V; ++v) reinterpret_cast<uint4*>(rs + t0)[v] = pack(y + v * V);
        }
    }
    __syncthreads();
    PHASE_STAMP(4);

    // the sums of x and r in row_sum's order, the max and the finite flag: one round
    const int steps = N > 0 ? N / SUM_T : (n + SUM_T - 1) / SUM_T;
    T s[2] = {(T)0, (T)0};
#pragma unroll
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        const bool in = N > 0 || idx < n;
        s[0] = add_rn(s[0], in ? xs[idx] : (T)0);
        s[1] = add_rn(s[1], in ? rs[idx] : (T)0);
    }
    warp_sums<T, 2>(s, sc_sum, 2, 0);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) peak = max_t(peak, __shfl_xor_sync(0xffffffffu, peak, sh));
    fin = __all_sync(0xffffffffu, fin) != 0;
    if ((tid & 31) == 0) {
        sc_peak[tid >> 5] = peak;
        fin_w[tid >> 5] = fin;
    }
    __syncthreads();
    PHASE_STAMP(5);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        peak = max_t(peak, sc_peak[w]);
        fin = fin && fin_w[w] != 0;
    }
    if (!(fin && peak <= (T)1e6)) {
        write_row(xs, out, n);
        finish<T>(nullptr, lpc_out, run_out);
        return;
    }

    // the centred energies of the row and of the residual: the second round
    const T len = (T)n;
    const T mean_x = div_rn(tree_sum(sc_sum, 2, 0), len);
    const T mean_r = div_rn(tree_sum(sc_sum, 2, 1), len);
    T e[2] = {(T)0, (T)0};
#pragma unroll
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        const bool in = N > 0 || idx < n;
        const T dx = in ? sub_rn(xs[idx], mean_x) : (T)0;
        const T dr = in ? sub_rn(rs[idx], mean_r) : (T)0;
        e[0] = add_rn(e[0], mul_rn(dx, dx));
        e[1] = add_rn(e[1], mul_rn(dr, dr));
    }
    warp_sums<T, 2>(e, sc_en, 2, 0);
    __syncthreads();
    PHASE_STAMP(6);
    const T oe = tree_sum(sc_en, 2, 0), re = tree_sum(sc_en, 2, 1);
    const T tiny = (T)1e-10;
    T gain = mul_rn((T)20, log10_t(re == (T)0 ? (T)1 : div_rn(oe, re)));
    if (oe < tiny || re < tiny || re >= oe) gain = (T)0;
    if (!(gain >= (T)MIN_PRED)) {
        write_row(xs, out, n);
        finish<T>(nullptr, lpc_out, run_out);
        return;
    }
    if (!r_out) write_row(rs, out, n);
    finish(coef + 16, lpc_out, run_out);
    PHASE_STAMP(7);
}

template <typename T, int N>
int go(const void* x, const void* ac, const void* gate, void* out, void* lpc_out, void* run,
       int lanes, int n, size_t smem, bool resid_global, cudaStream_t s) {
    auto kernel = tns_fir_gate_kernel<T, N>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<lanes, NT, smem, s>>>((const T*)x, (const T*)ac, (const uint8_t*)gate, (T*)out,
                                   (T*)lpc_out, (uint8_t*)run, n, resid_global);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* ac, const void* gate, void* out, void* lpc_out, void* run,
           int lanes, int n, cudaStream_t s) {
    const size_t n8 = ((size_t)n + 7) & ~(size_t)7;
    size_t smem = (EXTRA + 2 * n8) * sizeof(T);
    bool resid_global = false;
    if (smem > SMEM_LIMIT) {             // r goes to `out`, x alone to shared memory
        resid_global = true;
        smem = (EXTRA + n8) * sizeof(T);
    }
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (n == 2048) return go<T, 2048>(x, ac, gate, out, lpc_out, run, lanes, n, smem, false, s);
    return go<T, 0>(x, ac, gate, out, lpc_out, run, lanes, n, smem, resid_global, s);
}

}  // namespace

extern "C" int frad_tns_fir_gate(const void* x, const void* ac, const void* gate, void* out,
                                 void* lpc_out, void* run, int lanes, int n, int is_f64,
                                 void* stream) {
    if (lanes <= 0 || n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    return is_f64 ? launch<double>(x, ac, gate, out, lpc_out, run, lanes, n, s)
                  : launch<float>(x, ac, gate, out, lpc_out, run, lanes, n, s);
}
