// tns_iir: Profile 2's TNS synthesis filter (all-pole IIR) on Hopper.
//
// Replaces the XLA device program `_iir` of frad_python_tpu/ops/
// tns_jax.py (a `lax.scan` over time): per lane (frame x channel), over
// x [L, N] with coefficients c [L, 13] (c[0] unused), float32 or float64:
//
//   y[t] = x[t] - sum_{j=1..12} c[j] * y[t-j],      y[t < 0] = 0
//
// with the sum taken as: the 12 products, then acc = +0, acc += p_j for
// j = 12, 11, .. 1 (oldest output first), then x[t] - acc; no fused
// multiply-add. That is the order of the eager PyTorch version
// (frad_python_tpu_torch/kernels/tns_iir.py:tns_iir_plain), and every
// operation here is the IEEE-rounded intrinsic, so the two are
// bit-identical. A lane with c = [1, 0, ...] (TNS bypassed) gives y = x
// bit for bit: acc stays +0. The JAX scan leaves the order of its sum to
// XLA, so this one was free to choose.
//
// Bound: by bytes 2 * L * N values (22.6 MB at [1378, 2048] float32:
// 6.8 us), but the recurrence has no parallelism along time and lanes are
// the only parallelism (L threads in all), so what sets the time is one
// thread's instruction stream: N steps of 12 multiplies, 12 adds and a
// subtract. Design:
//
// * Oldest first makes the sum a transposed-form filter: step t keeps
//   r[k], the sum that step t + k has gathered so far (its terms j = 12
//   .. k + 1 are already known), so y[t] = x[t] - r[1] and then
//   r[k] <- r[k + 1] + c[k] * y[t] for k = 1 .. 12, with r[13] = +0.
//   These are the same products added in the same order, but the 12
//   updates of a step do not depend on one another, and only
//   c[1] * y[t], its add and the next subtract lie between two outputs:
//   3 dependent operations a step where newest first had 14. A step is
//   then bound by the warp's issue rate, not by latency: the compiler
//   makes 27 machine operations of a step (12 FMUL, 13 FADD, the tile's
//   LDS and STS), and one warp issues one every two cycles: 53 cycles a
//   step measured at 1980 MHz on an H100 (tools/kernel_probe.py), where
//   the 14-operation chain took ~142.
// * A warp owns 32 lanes and walks time in tiles of 32 steps through two
//   padded shared-memory tiles: row r of a tile is lane r's 32 samples,
//   loaded as one coalesced row. While a tile computes, the next tile's
//   rows arrive by cp.async into the other buffer. A thread reads its
//   own row into registers before the chain starts, runs the 32 steps
//   fully unrolled (the shifts of r[] are register renaming), writes y
//   back over its own row, and the warp stores the tile as coalesced
//   rows once the next tile's loads are in flight. One warp a block, so
//   __syncwarp() is the only barrier.

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

// one element, global -> shared, asynchronously (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
    const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem);
    if (sizeof(T) == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(gmem) : "memory");
}

// tile `t0`'s rows into `tile`: thread = step, one coalesced row a lane
template <typename T>
__device__ __forceinline__ void load_tile(T (*tile)[TILE + 1], const T* __restrict__ x,
                                          int lane0, int rows, int n, int t0, int tid) {
    if (t0 + tid < n)
        for (int row = 0; row < rows; ++row)
            copy_async(&tile[row][tid], x + (long long)(lane0 + row) * n + t0 + tid);
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(TILE)
tns_iir_kernel(const T* __restrict__ x, const T* __restrict__ coeffs,
               T* __restrict__ y, int lanes, int n) {
    __shared__ T tile[2][TILE][TILE + 1];
    const int tid = threadIdx.x;                      // 0 .. 31
    const int lane0 = blockIdx.x * TILE;
    const int lane = lane0 + tid;
    const int rows = min(TILE, lanes - lane0);        // lanes of this warp

    T a[ORDER], r[ORDER + 1];                         // a[k - 1] = c[k]; r[k - 1]: see above
#pragma unroll
    for (int k = 0; k < ORDER; ++k)
        a[k] = lane < lanes ? coeffs[(long long)lane * (ORDER + 1) + 1 + k] : (T)0;
    // before step 0 the sum of step k - 1 holds its terms j = 12 .. k, the
    // products with y[t < 0] = +0 (+0 unless a coefficient is not finite)
    r[ORDER] = (T)0;
#pragma unroll
    for (int k = ORDER - 1; k >= 0; --k) r[k] = add_rn(r[k + 1], mul_rn(a[k], (T)0));

    load_tile(tile[0], x, lane0, rows, n, 0, tid);
    for (int t0 = 0, buf = 0; t0 < n; t0 += TILE, buf ^= 1) {
        const int steps = min(TILE, n - t0);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncwarp();                                 // this tile is here; the other is stored
        if (t0 + TILE < n) load_tile(tile[buf ^ 1], x, lane0, rows, n, t0 + TILE, tid);

        T v[TILE];
#pragma unroll
        for (int s = 0; s < TILE; ++s) v[s] = tile[buf][tid][s];
#pragma unroll
        for (int s = 0; s < TILE; ++s) {
            const T yt = sub_rn(v[s], r[0]);
#pragma unroll
            for (int k = 0; k < ORDER; ++k) r[k] = add_rn(r[k + 1], mul_rn(a[k], yt));
            v[s] = yt;
        }
#pragma unroll
        for (int s = 0; s < TILE; ++s) tile[buf][tid][s] = v[s];
        __syncwarp();
        if (tid < steps)
            for (int row = 0; row < rows; ++row)
                y[(long long)(lane0 + row) * n + t0 + tid] = tile[buf][row][tid];
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
