// tns_autocorr: the front of Profile 2's TNS analysis on Hopper.
//
// Replaces the XLA device programs `_autocorr`, `_flatness_gate` and the
// energy gate of frad_python_tpu/ops/tns_jax.py (and the masked divide in
// front of them in frad_python_tpu/models/batch.py:_p2_encode_jit), about
// ninety launches as eager PyTorch ops. Per row (one lane = one frame and
// channel) of N values:
//
//   x    = div ? freqs / (div == 0 ? inf : div) : freqs        (written out)
//   gate = N >= 24 and exp(mean(log(|x| + 1e-10))) / (mean(|x|) + 1e-10) < 0.5
//          and sum(x^2) >= 1e-10
//   sig  = x - mean(x); norm = sqrt(sum(sig^2)); sig /= norm where norm > 1e-6
//   ac[l] = sum_t sig[t] * sig[t + l] * window[l],   l = 0 .. 12
//
// Every sum follows the order fixed in tns_reduce.cuh (256 running sums, an
// owner thread t adding elements t, t + 256, ... from +0, then a fixed
// tree), every operation is one IEEE rounding, so the kernel is
// bit-identical to kernels/tns_autocorr.py:tns_autocorr_plain; logf / expf
// are the device library's, as in PyTorch's own kernels.
//
// Bound: bytes (the row is read once, 11.3 MB at 1,378 rows of 2048
// float32; with a divisor twice that and the row written once); at the
// streaming engines' 8 rows, the launch, one round trip to memory and the
// row's chain of passes. Design: a block of 512 threads a row, two threads
// for each of the 256 owners of the sums.
// - The row reaches shared memory in one round: at 2048 samples each of the
//   512 threads issues its 4 loads and 4 divisor loads before it uses any
//   (in a loop that loads, divides and stores one element at a time they
//   wait on each other), divides them and writes x out (a warp's stores are
//   128 contiguous bytes). A bulk copy of the row (cp.async.bulk on an
//   mbarrier, a 16-byte store of x from shared memory) was measured slower
//   at float32 at 8 and at 1,378 rows (tools/kernel_probe.py
//   autocorr_variants; PERF.md) and is not used.
// - A running sum may live in any thread as long as its adds keep their
//   order, so the two threads of an owner share its sums: the first takes
//   x, x^2 and |x|, the second log(|x| + 1e-10); in the 13-lag pass the
//   first takes lags 0-6 and the second lags 7-12. warp_sums / tree_sum of
//   tns_reduce.cuh give each sum its fixed tree. The centring sum
//   is one chain and stays with the first thread, while a second thread
//   works out the gate; centring and normalising run over all 512.
// - For the codec's 2048-sample frames an owner's steps are a compile-time
//   count, so its loops unroll: the loads and the logarithms of a thread's
//   elements are independent and overlap, and only the last step checks the
//   row's end. Other lengths (tail frames) count their steps at run time.

#include "tns_reduce.cuh"

namespace {

using namespace tns;

constexpr int NT = 2 * SUM_T;            // threads a block: two per owner
constexpr int LAGS0 = 7;                 // lags of the first thread of an owner
constexpr int LAG_KT = 2 * LAGS0;        // scratch slots of the lag sums (13 used)
constexpr int SCRATCH = WARPS * (4 + 1 + LAG_KT);
constexpr int LOADS = 4;                 // a thread's loads a pass: 2048 / NT
constexpr size_t SMEM_LIMIT = 232448 - 64;

// An owner's steps: S > 0 is ceil(n / 256) known at compile time, for rows
// long enough that only the last step reaches past the row, even with a lag
// of 12 (n >= 256 (S - 1) + 12); S = 0 reads n at run time.
template <int S>
__device__ __forceinline__ bool full_step(int i) {
    return S > 0 && i < S - 1;
}

// A block a row. At float32 the hint of 4 blocks an SM holds the kernel to
// 32 registers (37 without it: 3 blocks an SM); float64 keeps its 3 blocks
// (4 would spill; a hint of 1 let it take 62 registers and run slower).
template <typename T, int S>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 4 : 3)
tns_autocorr_kernel(const T* __restrict__ freqs, const T* __restrict__ div,   // div may be null
                    const T* __restrict__ window, T* __restrict__ x_out,      // null without div
                    T* __restrict__ ac_out, uint8_t* __restrict__ gate_out, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const row = reinterpret_cast<T*>(smem_raw);
    T* const sc1 = row + n;                                 // x, x^2, |x|, log
    T* const sc2 = sc1 + WARPS * 4;                         // centred energy
    T* const sc3 = sc2 + WARPS;                             // lags
    const int tid = threadIdx.x;
    const T tiny = (T)1e-10;
    const T len = (T)n;
    const int steps = S > 0 ? S : (n + SUM_T - 1) / SUM_T;
    const int h = tid >= SUM_T;
    const int t = tid - h * SUM_T;
    const int r = blockIdx.x;
    const long long base = (long long)r * n;
    // the row into shared memory, divided: all LOADS loads of a pass (and
    // their divisors) leave before any is used; one pass at 2048 samples
    for (int i0 = tid; i0 < n; i0 += LOADS * NT) {
        T xv[LOADS], dv[LOADS];
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
            const int idx = i0 + k * NT;
            xv[k] = idx < n ? freqs[base + idx] : (T)0;
            dv[k] = div != nullptr && idx < n ? div[base + idx] : (T)1;
        }
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
            const int idx = i0 + k * NT;
            if (idx < n) {
                T x = xv[k];
                if (div != nullptr) {
                    x = div_rn(x, dv[k] == (T)0 ? (T)INFINITY : dv[k]);
                    x_out[base + idx] = x;
                }
                row[idx] = x;
            }
        }
    }
    __syncthreads();

    // pass 1: the first thread of an owner sums x, x^2 and |x|, the second log(|x| + tiny)
    if (h == 0) {
        T s[3] = {(T)0, (T)0, (T)0};
#pragma unroll
        for (int i = 0; i < steps; ++i) {
            const int idx = t + i * SUM_T;
            T x = (T)0, q = (T)0, m = (T)0;
            if (full_step<S>(i) || idx < n) {
                x = row[idx];
                q = mul_rn(x, x);
                m = abs_t(x);
            }
            s[0] = add_rn(s[0], x);
            s[1] = add_rn(s[1], q);
            s[2] = add_rn(s[2], m);
        }
        warp_sums<T, 3>(s, sc1, 4, 0);
    } else {
        T s[1] = {(T)0};
#pragma unroll
        for (int i = 0; i < steps; ++i) {
            const int idx = t + i * SUM_T;
            T lg = (T)0;
            if (full_step<S>(i) || idx < n)
                lg = log_t(add_rn(abs_t(row[idx]), tiny));
            s[0] = add_rn(s[0], lg);
        }
        warp_sums<T, 1>(s, sc1, 4, 3);
    }
    __syncthreads();
    const T mean = div_rn(tree_sum(sc1, 4, 0), len);

    // pass 2: the energy of the centred row (first threads); the gate (a second thread)
    if (h == 0) {
        T e[1] = {(T)0};
#pragma unroll
        for (int i = 0; i < steps; ++i) {
            const int idx = t + i * SUM_T;
            T sq = (T)0;
            if (full_step<S>(i) || idx < n) {
                const T sig = sub_rn(row[idx], mean);
                sq = mul_rn(sig, sig);
            }
            e[0] = add_rn(e[0], sq);
        }
        warp_sums<T, 1>(e, sc2, 1, 0);
    } else if (t == 0) {
        bool g = false;
        if (n >= 2 * (ORDER1 - 1)) {
            const T geo = exp_t(div_rn(tree_sum(sc1, 4, 3), len));
            const T ari = div_rn(tree_sum(sc1, 4, 2), len);
            g = div_rn(geo, add_rn(ari, tiny)) < (T)0.5;
        }
        gate_out[r] = (uint8_t)(g && tree_sum(sc1, 4, 1) >= tiny);
    }
    __syncthreads();
    // centre and normalise (every thread, element by element)
    const T norm = sqrt_rn(tree_sum(sc2, 1, 0));
    const bool scale = norm > (T)1e-6;
#pragma unroll 4
    for (int idx = tid; idx < n; idx += NT) {
        const T sig = sub_rn(row[idx], mean);
        row[idx] = scale ? div_rn(sig, norm) : sig;
    }
    __syncthreads();

    // pass 3: the 13 lag products, lags 0-6 in the first thread of an owner, 7-12 in
    // the second
    const int l0 = h * LAGS0;
    const int nl = h ? ORDER1 - LAGS0 : LAGS0;
    T acc[LAGS0];
#pragma unroll
    for (int j = 0; j < LAGS0; ++j) acc[j] = (T)0;
#pragma unroll
    for (int i = 0; i < steps; ++i) {
        const int idx = t + i * SUM_T;
        const bool full = full_step<S>(i);
        const T a = full || idx < n ? row[idx] : (T)0;
#pragma unroll
        for (int j = 0; j < LAGS0; ++j) {
            if (j < nl) {
                const int l = l0 + j;
                const T v = full || idx + l < n ? mul_rn(a, row[idx + l]) : (T)0;
                acc[j] = add_rn(acc[j], v);
            }
        }
    }
    warp_sums<T, LAGS0>(acc, sc3, LAG_KT, l0);
    __syncthreads();
    if (tid < ORDER1)
        ac_out[(long long)r * ORDER1 + tid] = mul_rn(tree_sum(sc3, LAG_KT, tid), window[tid]);
}

template <typename T, int S>
int go(const void* freqs, const void* div, const void* window, void* x_out, void* ac,
       void* gate, int lanes, int n, size_t smem, cudaStream_t s) {
    auto kernel = tns_autocorr_kernel<T, S>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<lanes, NT, smem, s>>>((const T*)freqs, (const T*)div, (const T*)window,
                                   (T*)x_out, (T*)ac, (uint8_t*)gate, n);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* freqs, const void* div, const void* window, void* x_out, void* ac,
           void* gate, int lanes, int n, cudaStream_t s) {
    const size_t smem = ((size_t)n + SCRATCH) * sizeof(T);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (n >= 7 * SUM_T + ORDER1 - 1 && n <= 8 * SUM_T)     // the codec's frames: 8 steps
        return go<T, 8>(freqs, div, window, x_out, ac, gate, lanes, n, smem, s);
    return go<T, 0>(freqs, div, window, x_out, ac, gate, lanes, n, smem, s);
}

}  // namespace

extern "C" int frad_tns_autocorr(const void* freqs, const void* div, const void* window,
                                 void* x_out, void* ac, void* gate, int lanes, int n,
                                 int is_f64, void* stream) {
    if (lanes <= 0 || n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    return is_f64 ? launch<double>(freqs, div, window, x_out, ac, gate, lanes, n, s)
                  : launch<float>(freqs, div, window, x_out, ac, gate, lanes, n, s);
}
