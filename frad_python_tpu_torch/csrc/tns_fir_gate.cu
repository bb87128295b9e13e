// tns_fir_gate: the back of Profile 2's TNS analysis on Hopper.
//
// Replaces the XLA device programs `_quantise`, `_dequantise`, `_fir`,
// `_predgain` and the gates and selects of `tns_analysis` in
// frad_python_tpu/ops/tns_jax.py, about ninety launches as eager PyTorch
// ops. Per row (one lane) of N values, with the raw LPC of tns_levinson and
// the gate of tns_autocorr:
//
//   run  = gate and |lpc[1]| + ... + |lpc[12]| >= 0.01        (j ascending)
//   q[j] = rint(clip(15 * lpc[j], -15, 14)), q[0] = 0;  run &= some q != 0
//   c    = q / 15, c[0] = 1
//   r[t] = c[0] x[t] + c[1] x[t-1] + ... + c[12] x[t-12]      (j ascending, x[<0] = 0)
//   run &= r finite and max |r| <= 1e6
//   oe = sum (x - mean x)^2, re = sum (r - mean r)^2
//   run &= not (oe < 1e-10 or re < 1e-10 or re >= oe)
//          and 20 log10(re == 0 ? 1 : oe / re) >= log10(2) / 10
//   out = run ? r : x;  lpc_out = run ? q : 0
//
// Bound: bytes (a row read once and written once: 22.6 MB at 1,378 rows of
// 2048 float32). Design: a block of 256 threads a row; the residual stays in
// shared memory between its two passes; the 13 taps read x through L1. A row
// whose gate is already false leaves after copying itself (the work depends
// on the data). The four sums follow the order fixed in tns_reduce.cuh and
// every operation is one IEEE rounding, so the kernel is bit-identical to
// kernels/tns_fir_gate.py:tns_fir_gate_plain; a NaN or infinite residual
// fails the finite test and never reaches the maximum (fmax drops a NaN);
// a bypassed row returns the input's bits.

#include "tns_reduce.cuh"

namespace {

using namespace tns;

template <typename T>
__device__ __forceinline__ void bypass(const T* __restrict__ x, T* __restrict__ out,
                                       T* __restrict__ lpc_out, uint8_t* __restrict__ run_out,
                                       int n) {
    for (int idx = threadIdx.x; idx < n; idx += SUM_T) out[idx] = x[idx];
    if (threadIdx.x < ORDER1) lpc_out[threadIdx.x] = (T)0;
    if (threadIdx.x == 0) *run_out = 0;
}

template <typename T>
__global__ void __launch_bounds__(SUM_T)
tns_fir_gate_kernel(const T* __restrict__ x_in, const T* __restrict__ lpc_in,
                    const uint8_t* __restrict__ gate_in, T* __restrict__ out_all,
                    T* __restrict__ lpc_out_all, uint8_t* __restrict__ run_all, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* resid = reinterpret_cast<T*>(smem_raw);
    T* scratch = resid + n;
    const long long lane = blockIdx.x;
    const T* x = x_in + lane * n;
    T* out = out_all + lane * n;
    T* lpc_out = lpc_out_all + lane * ORDER1;
    uint8_t* run_out = run_all + lane;
    const int tid = threadIdx.x;
    const int steps = (n + SUM_T - 1) / SUM_T;
    const T tiny = (T)1e-10;
    const T scale = (T)15;
    const T len = (T)n;

    // the coefficients: every thread works out the same 13 values
    T q[ORDER1], c[ORDER1];
    T total = (T)0;
    bool any = false;
    q[0] = (T)0;
    c[0] = (T)1;
#pragma unroll
    for (int j = 1; j < ORDER1; ++j) {
        const T l = lpc_in[lane * ORDER1 + j];
        total = j == 1 ? abs_t(l) : add_rn(total, abs_t(l));
        const T v = mul_rn(l, scale);
        const T clipped = v != v ? v : (v < -scale ? -scale : (v > scale - (T)1 ? scale - (T)1 : v));
        q[j] = rint_t(clipped);
        any = any || (q[j] != (T)0);
        c[j] = div_rn(q[j], scale);
    }
    if (!(gate_in[lane] != 0 && total >= (T)0.01 && any)) {
        bypass(x, out, lpc_out, run_out, n);
        return;
    }

    // pass 1: the residual into shared memory; sum x, sum r, max |r|, all finite
    T s[2] = {(T)0, (T)0};
    T peak = (T)0;
    int fin = 1;
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        T xv = (T)0, y = (T)0;
        if (idx < n) {
            xv = x[idx];
            y = mul_rn(c[0], xv);
#pragma unroll
            for (int j = 1; j < ORDER1; ++j)
                y = add_rn(y, mul_rn(c[j], idx >= j ? x[idx - j] : (T)0));
            resid[idx] = y;
            peak = max_t(peak, abs_t(y));
            fin &= (int)isfinite(y);
        }
        s[0] = add_rn(s[0], xv);
        s[1] = add_rn(s[1], y);
    }
    block_sum<T, 2>(s, scratch);
    fin = __syncthreads_and(fin);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) peak = max_t(peak, __shfl_xor_sync(0xffffffffu, peak, sh));
    if ((tid & 31) == 0) scratch[tid >> 5] = peak;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) peak = max_t(peak, scratch[w]);
    if (!(fin && peak <= (T)1e6)) {
        bypass(x, out, lpc_out, run_out, n);
        return;
    }

    // pass 2: the centred energies of the row and of the residual
    const T mean_x = div_rn(s[0], len), mean_r = div_rn(s[1], len);
    T e[2] = {(T)0, (T)0};
    for (int i = 0; i < steps; ++i) {
        const int idx = tid + i * SUM_T;
        T oc = (T)0, rc = (T)0;
        if (idx < n) {
            oc = sub_rn(x[idx], mean_x);
            rc = sub_rn(resid[idx], mean_r);
        }
        e[0] = add_rn(e[0], mul_rn(oc, oc));
        e[1] = add_rn(e[1], mul_rn(rc, rc));
    }
    block_sum<T, 2>(e, scratch);
    const T oe = e[0], re = e[1];
    T gain = mul_rn((T)20, log10_t(re == (T)0 ? (T)1 : div_rn(oe, re)));
    if (oe < tiny || re < tiny || re >= oe) gain = (T)0;
    if (!(gain >= (T)0.030102999566398118)) {
        bypass(x, out, lpc_out, run_out, n);
        return;
    }

    for (int idx = tid; idx < n; idx += SUM_T) out[idx] = resid[idx];
#pragma unroll
    for (int j = 0; j < ORDER1; ++j) {
        if (tid == j) lpc_out[j] = q[j];
    }
    if (tid == 0) *run_out = 1;
}

template <typename T>
int launch(const void* x, const void* lpc, const void* gate, void* out, void* lpc_out,
           void* run, int lanes, int n, cudaStream_t s) {
    const size_t smem = ((size_t)n + WARPS * 2) * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(tns_fir_gate_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    tns_fir_gate_kernel<T><<<lanes, SUM_T, smem, s>>>(
        (const T*)x, (const T*)lpc, (const uint8_t*)gate, (T*)out, (T*)lpc_out, (uint8_t*)run, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frad_tns_fir_gate(const void* x, const void* lpc, const void* gate, void* out,
                                 void* lpc_out, void* run, int lanes, int n, int is_f64,
                                 void* stream) {
    if (lanes <= 0 || n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    return is_f64 ? launch<double>(x, lpc, gate, out, lpc_out, run, lanes, n, s)
                  : launch<float>(x, lpc, gate, out, lpc_out, run, lanes, n, s);
}
