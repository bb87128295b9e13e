// tns_iir: Profile 2's TNS synthesis filter (all-pole IIR) on Hopper.
//
// Replaces the XLA device program `_iir` of frad_python_tpu/ops/
// tns_jax.py (a `lax.scan` over time): per lane (frame x channel), over
// x [L, N] with coefficients c [L, 13] (c[0] unused), float32 or float64:
//
//   y[t] = x[t] - sum_{j=1..12} c[j] * y[t-j],      y[t < 0] = 0
//
// with the sum taken as: the 12 products, then acc = 0, acc += p_j for
// j = 1 .. 12 in order, then x[t] - acc; no fused multiply-add. That is
// the order of the eager PyTorch version (frad_python_tpu_torch/kernels/
// tns_iir.py:tns_iir_plain), and every operation here is the IEEE-rounded
// intrinsic, so the two are bit-identical. A lane with c = [1, 0, ...]
// (TNS bypassed) gives y = x bit for bit: acc stays +0.
//
// Bound: by bytes 2 * L * N values (22.6 MB at [1378, 2048] float32),
// but the recurrence is a chain of N steps of 12 dependent adds and a
// subtract per lane, and lanes are the only parallelism (L threads in
// all), so the chain's latency, not the memory, sets the time. Design:
// one thread per lane with the last 12 outputs in registers (a rotating
// window, fully unrolled, so no indexing into local memory). A thread
// per lane would read x with stride N; instead a warp owns 32 lanes and
// walks time in tiles of 32 steps staged through shared memory: the warp
// loads lane r's 32 consecutive samples as one coalesced row (128 bytes
// at float32), each thread then runs its own lane's 32 steps from the
// padded tile (no bank conflicts) and writes y back into it, and the tile
// is stored as coalesced rows. One warp per block, so __syncwarp() is
// the only barrier.

#include <cuda_runtime.h>

namespace {

constexpr int ORDER = 12;
constexpr int TILE = 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void tns_iir_kernel(const T* __restrict__ x, const T* __restrict__ coeffs,
                               T* __restrict__ y, int lanes, int n) {
    __shared__ T tile[TILE][TILE + 1];
    const int tid = threadIdx.x;                      // 0 .. 31
    const int lane0 = blockIdx.x * TILE;
    const int lane = lane0 + tid;
    const bool live = lane < lanes;

    T a[ORDER], hist[ORDER];                          // hist[0] = y[t-1]
#pragma unroll
    for (int j = 0; j < ORDER; ++j) {
        a[j] = live ? coeffs[(long long)lane * (ORDER + 1) + 1 + j] : (T)0;
        hist[j] = (T)0;
    }

    for (int t0 = 0; t0 < n; t0 += TILE) {
        const int steps = min(TILE, n - t0);
        // coalesced load: row r of the tile is lane lane0 + r, thread = step
        for (int r = 0; r < TILE; ++r) {
            int l = lane0 + r;
            if (l < lanes && tid < steps)
                tile[r][tid] = x[(long long)l * n + t0 + tid];
        }
        __syncwarp();
        if (live) {
            for (int s = 0; s < steps; ++s) {
                T p[ORDER];
#pragma unroll
                for (int j = 0; j < ORDER; ++j) p[j] = mul_rn(a[j], hist[j]);
                T acc = (T)0;
#pragma unroll
                for (int j = 0; j < ORDER; ++j) acc = add_rn(acc, p[j]);
                T yt = sub_rn(tile[tid][s], acc);
#pragma unroll
                for (int j = ORDER - 1; j > 0; --j) hist[j] = hist[j - 1];
                hist[0] = yt;
                tile[tid][s] = yt;
            }
        }
        __syncwarp();
        for (int r = 0; r < TILE; ++r) {
            int l = lane0 + r;
            if (l < lanes && tid < steps)
                y[(long long)l * n + t0 + tid] = tile[r][tid];
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int frad_tns_iir(const void* x, const void* coeffs, void* y,
                            int lanes, int n, int is_f64, void* stream) {
    if (lanes <= 0 || n <= 0) return 0;
    int blocks = (lanes + TILE - 1) / TILE;
    if (is_f64)
        tns_iir_kernel<double><<<blocks, TILE, 0, (cudaStream_t)stream>>>(
            (const double*)x, (const double*)coeffs, (double*)y, lanes, n);
    else
        tns_iir_kernel<float><<<blocks, TILE, 0, (cudaStream_t)stream>>>(
            (const float*)x, (const float*)coeffs, (float*)y, lanes, n);
    return (int)cudaGetLastError();
}
