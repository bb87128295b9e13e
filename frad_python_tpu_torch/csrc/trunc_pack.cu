// trunc_pack: the Profile 0 encoder's truncated-float packing on Hopper.
//
// Replaces the XLA device program that the JAX package fuses after the
// forward DCT (frad_python_tpu/ops/bitpack.py:trunc_pack, called from
// frad_python_tpu/models/batch.py:_p0_encode_pack_jit), including its
// frame-major transpose and the per-frame max|x|:
//
//   value m = t*C + c of frame b is y[b, c, t]        (interleaved row)
//   bits 16: the f16 of the value (round to nearest even), 2 bytes
//   bits 24: the top three bytes of the f32 bits, 3 bytes
//   bits 32: the f32 bits, 4 bytes
//   big-endian byte order unless `little`; bytes of value m land at
//   m * bytes-per-value of frame b's payload
//   maxabs[b] = max over the frame of |value|, NaN when any value is NaN
//
// The output is the payload's byte stream; the wrapper allocates it as
// int16 or int32 words whose little-endian bytes are that stream, equal
// byte for byte to frad_python_tpu_torch/ops/packing.pack_floats of the
// same float32 values.
//
// Bound: bytes (each value read once, 4 bytes, and written once, 2-4
// bytes); at the streaming engines' two frames a launch, the launch and
// one round trip to memory. Design:
// - A thread owns one group of GROUP = 16 consecutive values of a frame's
//   interleaved row: 4 float4 loads at C = 1 and C = 2 (the channel count
//   is a template argument there; other counts load value by value with
//   32-bit index arithmetic), all started before any use, so a thread makes
//   one round trip to memory.
// - The group's 32-64 bytes are assembled in registers, one __byte_perm a
//   word (the two byte orders differ only in the selectors of `selectors`),
//   and stored as 16-byte vectors along the payload.
// - A frame is one cluster of 1-8 blocks (kernels/trunc_pack.py:geometry
//   picks blocks and threads so that every thread has a group at the
//   shapes the codec uses). Each block reduces its max by warp reductions;
//   block 0 of the cluster reads the other blocks' maxima from their
//   shared memory (distributed shared memory) after a cluster barrier.
//   One launch, no atomics, no zeroed output. The max is an unsigned max
//   of the bits of |x|: for non-negative floats the bit order is the
//   value order and a NaN's bits order above inf, so any order of the
//   reduction gives the same bits, and a NaN frame reports NaN as jnp.max.
// - Rows whose payload is not whole 16-byte vectors (M = C*N not a
//   multiple of 16, or a misaligned pointer) take the same kernel with
//   value-by-value loads, masked past the row's end, and byte stores.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GROUP = 16;
constexpr int MAX_CLUSTER = 8;

// __byte_perm selectors of a group's words: s[k] builds word k from two
// adjacent values (bits 24: values k and k + 1 of four; bits 16: the two
// halves of word k; bits 32: one value). tests/test_torch_trunc.py reads
// these lines and models the words with them.
struct Sel { unsigned int s0, s1, s2; };

__device__ __forceinline__ Sel selectors(int bits, bool little) {
    if (bits == 16) return little ? Sel{0x5410u, 0u, 0u} : Sel{0x4501u, 0u, 0u};
    if (bits == 24) return little ? Sel{0x5321u, 0x6532u, 0x7653u} : Sel{0x7123u, 0x6712u, 0x5671u};
    return little ? Sel{0x3210u, 0u, 0u} : Sel{0x0123u, 0u, 0u};
}

// values a thread loads: CT = 1 or 2 read float4s of the channel rows
// (VEC launches only), CT = 0 reads value by value, 0 past the row's end
template <int CT, bool VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ frame, int m, int M,
                                           int C, int N, float (&v)[GROUP]) {
    if (VEC && CT == 1) {
#pragma unroll
        for (int q = 0; q < GROUP / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(frame + m)[q];
            v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
        }
    } else if (VEC && CT == 2) {
        const int t0 = m >> 1;
        const float4* r0 = reinterpret_cast<const float4*>(frame + t0);
        const float4* r1 = reinterpret_cast<const float4*>(frame + N + t0);
        const float4 a0 = r0[0], a1 = r0[1], b0 = r1[0], b1 = r1[1];
        v[0] = a0.x; v[1] = b0.x; v[2] = a0.y; v[3] = b0.y;
        v[4] = a0.z; v[5] = b0.z; v[6] = a0.w; v[7] = b0.w;
        v[8] = a1.x; v[9] = b1.x; v[10] = a1.y; v[11] = b1.y;
        v[12] = a1.z; v[13] = b1.z; v[14] = a1.w; v[15] = b1.w;
    } else {
        int t = m / C;
        int c = m - t * C;
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
            v[k] = (VEC || m + k < M) ? frame[c * N + t] : 0.0f;
            if (++c == C) { c = 0; ++t; }
        }
    }
}

// the group's words, in payload order (word k's little-endian bytes are the
// payload's bytes 4k .. 4k + 3 of the group)
template <int BITS>
__device__ __forceinline__ void pack_group(const float (&v)[GROUP], Sel s,
                                           unsigned int (&w)[GROUP * BITS / 32]) {
    if (BITS == 16) {
#pragma unroll
        for (int k = 0; k < GROUP / 2; ++k)
            w[k] = __byte_perm(__half_as_ushort(__float2half_rn(v[2 * k])),
                               __half_as_ushort(__float2half_rn(v[2 * k + 1])), s.s0);
    } else if (BITS == 24) {
#pragma unroll
        for (int q = 0; q < GROUP / 4; ++q) {
            const unsigned int u0 = __float_as_uint(v[4 * q]), u1 = __float_as_uint(v[4 * q + 1]);
            const unsigned int u2 = __float_as_uint(v[4 * q + 2]);
            const unsigned int u3 = __float_as_uint(v[4 * q + 3]);
            w[3 * q] = __byte_perm(u0, u1, s.s0);
            w[3 * q + 1] = __byte_perm(u1, u2, s.s1);
            w[3 * q + 2] = __byte_perm(u2, u3, s.s2);
        }
    } else {
#pragma unroll
        for (int k = 0; k < GROUP; ++k) w[k] = __byte_perm(__float_as_uint(v[k]), 0u, s.s0);
    }
}

template <int CT, int BITS, bool VEC>
__global__ void __launch_bounds__(1024)
trunc_pack_kernel(const float* __restrict__ y, uint8_t* __restrict__ out,
                  float* __restrict__ maxabs, int C, int N, int little, int cps) {
    constexpr int BPV = BITS / 8;
    constexpr int WORDS = GROUP * BITS / 32;
    const int M = C * N;
    const int groups = (M + GROUP - 1) / GROUP;
    const int b = blockIdx.x / cps;
    const int rank = blockIdx.x - b * cps;
    const float* frame = y + (long long)b * M;
    uint8_t* dst = out + (long long)b * M * BPV;
    const Sel s = selectors(BITS, little != 0);
    unsigned int mx = 0u;
    for (int g = rank * blockDim.x + threadIdx.x; g < groups; g += cps * blockDim.x) {
        const int m = g * GROUP;
        float v[GROUP];
        load_group<CT, VEC>(frame, m, M, C, N, v);
#pragma unroll
        for (int k = 0; k < GROUP; ++k) mx = max(mx, __float_as_uint(fabsf(v[k])));
        unsigned int w[WORDS];
        pack_group<BITS>(v, s, w);
        if (VEC) {
            uint4* d = reinterpret_cast<uint4*>(dst + (long long)m * BPV);
#pragma unroll
            for (int q = 0; q < WORDS / 4; ++q)
                d[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
        } else {
            const int nbytes = min(GROUP, M - m) * BPV;
#pragma unroll
            for (int p = 0; p < GROUP * BPV; ++p)
                if (p < nbytes) dst[(long long)m * BPV + p] = (uint8_t)(w[p >> 2] >> (8 * (p & 3)));
        }
    }

    __shared__ unsigned int warp_max[32];
    __shared__ unsigned int block_max;
    mx = __reduce_max_sync(0xffffffffu, mx);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_max[warp] = mx;
    __syncthreads();
    if (warp == 0) {
        mx = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0u;
        mx = __reduce_max_sync(0xffffffffu, mx);
        if (lane == 0) block_max = mx;
    }
    if (cps == 1) {
        if (threadIdx.x == 0) maxabs[b] = __uint_as_float(mx);
        return;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                      // every block's max is in its shared memory
    if (rank == 0 && threadIdx.x == 0) {
        for (int r = 1; r < cps; ++r) mx = max(mx, *cluster.map_shared_rank(&block_max, r));
        maxabs[b] = __uint_as_float(mx);
    }
    cluster.sync();                      // no block leaves while block 0 reads it
}

template <int CT, int BITS, bool VEC>
int launch(const float* y, uint8_t* out, float* maxabs, int B, int C, int N, int little,
           int cps, int threads, cudaStream_t stream) {
    auto kernel = trunc_pack_kernel<CT, BITS, VEC>;
    if (cps == 1) {
        kernel<<<(unsigned int)B, threads, 0, stream>>>(y, out, maxabs, C, N, little, cps);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)(B * cps));
    cfg.blockDim = dim3((unsigned int)threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned int)cps;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, y, out, maxabs, C, N, little, cps);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int BITS>
int dispatch(const float* y, uint8_t* out, float* maxabs, int B, int C, int N, int little,
             int cps, int threads, cudaStream_t stream) {
    const long long m = (long long)C * N;
    const bool vec = m % GROUP == 0 && (uintptr_t)y % 16 == 0 && (uintptr_t)out % 16 == 0;
    if (vec && C == 1) return launch<1, BITS, true>(y, out, maxabs, B, C, N, little, cps, threads, stream);
    if (vec && C == 2) return launch<2, BITS, true>(y, out, maxabs, B, C, N, little, cps, threads, stream);
    if (vec) return launch<0, BITS, true>(y, out, maxabs, B, C, N, little, cps, threads, stream);
    return launch<0, BITS, false>(y, out, maxabs, B, C, N, little, cps, threads, stream);
}

}  // namespace

// cps (blocks a frame, the cluster's size) and threads (a block) come from
// kernels/trunc_pack.py:geometry; any values in range are correct.
extern "C" int frad_trunc_pack(const float* y, void* out, float* maxabs, int B, int C, int N,
                               int bits, int little, int cps, int threads, void* stream) {
    if (B <= 0) return 0;
    if (cps < 1 || cps > MAX_CLUSTER || threads < 32 || threads > 1024 || threads % 32 != 0
        || (long long)C * N > 0x7fffffffLL - GROUP)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    uint8_t* o = (uint8_t*)out;
    if (bits == 16) return dispatch<16>(y, o, maxabs, B, C, N, little, cps, threads, s);
    if (bits == 24) return dispatch<24>(y, o, maxabs, B, C, N, little, cps, threads, s);
    if (bits == 32) return dispatch<32>(y, o, maxabs, B, C, N, little, cps, threads, s);
    return (int)cudaErrorInvalidValue;
}
