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
// Bound: bytes (the row is read once, 11.3 MB at 1,378 rows of 2048 float32;
// with a divisor twice that and the row written once). Design: a block of
// 256 threads a row; the row stays in shared memory from the first pass on,
// so the 13 lag products read it there; 18 sums in three block reductions
// (4, 1 and 13 at a time). Every sum follows the order fixed in
// tns_reduce.cuh, every operation is one IEEE rounding, so the kernel is
// bit-identical to kernels/tns_autocorr.py:tns_autocorr_plain; logf / expf
// are the device library's, as in PyTorch's own kernels.

#include "tns_reduce.cuh"

namespace {

using namespace tns;

template <typename T>
__global__ void __launch_bounds__(SUM_T)
tns_autocorr_kernel(const T* __restrict__ freqs, const T* __restrict__ div,   // div may be null
                    const T* __restrict__ window, T* __restrict__ x_out,      // null without div
                    T* __restrict__ ac_out, uint8_t* __restrict__ gate_out, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* row = reinterpret_cast<T*>(smem_raw);
    T* scratch = row + n;
    const long long base = (long long)blockIdx.x * n;
    const int tid = threadIdx.x;
    const int steps = (n + SUM_T - 1) / SUM_T;
    const T tiny = (T)1e-10;
    const T len = (T)n;

    // pass 1: the divided row into shared memory; sum x, log(|x| + tiny), |x|, x^2
    T s[4] = {(T)0, (T)0, (T)0, (T)0};
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        T x = (T)0, lg = (T)0, mg = (T)0, sq = (T)0;
        if (idx < n) {
            x = freqs[base + idx];
            if (div != nullptr) {
                const T d = div[base + idx];
                x = div_rn(x, d == (T)0 ? (T)INFINITY : d);
                x_out[base + idx] = x;
            }
            row[idx] = x;
            mg = abs_t(x);
            lg = log_t(add_rn(mg, tiny));
            sq = mul_rn(x, x);
        }
        s[0] = add_rn(s[0], x);
        s[1] = add_rn(s[1], lg);
        s[2] = add_rn(s[2], mg);
        s[3] = add_rn(s[3], sq);
    }
    block_sum<T, 4>(s, scratch);
    if (tid == 0) {
        bool g = false;
        if (n >= 2 * (ORDER1 - 1)) {
            const T geo = exp_t(div_rn(s[1], len));
            const T ari = div_rn(s[2], len);
            g = div_rn(geo, add_rn(ari, tiny)) < (T)0.5;
        }
        gate_out[blockIdx.x] = (uint8_t)(g && s[3] >= tiny);
    }

    // pass 2: centre, energy of the centred row (a thread keeps to its own elements)
    const T mean = div_rn(s[0], len);
    T e[1] = {(T)0};
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        T sq = (T)0;
        if (idx < n) {
            const T sig = sub_rn(row[idx], mean);
            row[idx] = sig;
            sq = mul_rn(sig, sig);
        }
        e[0] = add_rn(e[0], sq);
    }
    block_sum<T, 1>(e, scratch);
    const T norm = sqrt_rn(e[0]);
    if (norm > (T)1e-6) {
        for (int idx = tid; idx < n; idx += SUM_T) row[idx] = div_rn(row[idx], norm);
    }
    __syncthreads();

    // pass 3: the 13 lag products
    T acc[ORDER1];
#pragma unroll
    for (int l = 0; l < ORDER1; ++l) acc[l] = (T)0;
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        const T a = idx < n ? row[idx] : (T)0;
#pragma unroll
        for (int l = 0; l < ORDER1; ++l) {
            const T v = idx + l < n ? mul_rn(a, row[idx + l]) : (T)0;
            acc[l] = add_rn(acc[l], v);
        }
    }
    block_sum<T, ORDER1>(acc, scratch);
#pragma unroll
    for (int l = 0; l < ORDER1; ++l) {
        if (tid == l) ac_out[(long long)blockIdx.x * ORDER1 + l] = mul_rn(acc[l], window[l]);
    }
}

template <typename T>
int launch(const void* freqs, const void* div, const void* window, void* x_out, void* ac,
           void* gate, int lanes, int n, cudaStream_t s) {
    const size_t smem = ((size_t)n + WARPS * ORDER1) * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(tns_autocorr_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    tns_autocorr_kernel<T><<<lanes, SUM_T, smem, s>>>(
        (const T*)freqs, (const T*)div, (const T*)window, (T*)x_out, (T*)ac, (uint8_t*)gate, n);
    return (int)cudaGetLastError();
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
