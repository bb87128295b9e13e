// trunc_unpack: the Profile 0 decoder's truncated-float unpacking on Hopper.
//
// Replaces the XLA device program that the JAX package fuses before the
// inverse DCT (frad_python_tpu/ops/bitpack.py:trunc_unpack, called from
// frad_python_tpu/models/batch.py:_p0_unpack_decode_jit), including the
// reshape to the IDCT's layout:
//
//   out[b, c, t] = value m = t*C + c of frame b's payload, where value m
//                  is the bytes at m * bytes-per-value, big-endian unless
//                  `little`, read as f16 (16), the top three bytes of an
//                  f32 (24) or an f32 (32)
//   a NaN or Inf becomes +0.0 (the reference decoder's scrub); -0.0 stays
//
// Input is the payload's byte stream (the int16 / int32 words the host
// uploads, little-endian), output the float32 [B, C, N] tensor the IDCT
// GEMM reads, so the transpose is folded into the kernel. It is the
// inverse of trunc_pack.cu, laid out the same way.
//
// Bound: bytes (each value read once, 2-4 bytes, and written once, 4
// bytes); at the streaming engines' two frames a launch, the launch and one
// round trip to memory. Design (each choice timed against its alternative on
// the card: tools/kernel_probe.py trunc_unpack, PERF.md):
// - A grid of (frame, chunk of the frame's bins); indices are 32-bit from
//   one 64-bit frame base, and no integer division runs.
//   kernels/trunc_unpack.py:geometry picks chunks and threads so that every
//   thread owns one group, in blocks of at most 128 threads (256-thread
//   blocks left a two-frame launch on too few SMs).
// - A thread owns one group of G bins of every channel: G*C consecutive
//   values of the payload, a whole number of 24-bit quads. G = 4, and 2 at C
//   = 8, so that each channel's bins leave as one 16- or 8-byte store and a
//   warp's store covers 512 or 256 contiguous bytes of a row. The channel
//   count is a template argument for C = 1, 2 and 8; any other count takes
//   a run-time path. The group's 8-64 payload bytes load in the widest
//   pieces that divide them (three 8-byte loads at C = 2, 24 bits), all
//   issued before any use, so a thread makes one round trip to memory.
//   Groups of 16 values (whole 16-byte loads at C = 2, 24 bits) were twice
//   as slow: their two 16-byte stores a channel at a 32-byte stride each
//   wrote half of every sector they touched.
// - Each value is put in place with one __byte_perm of the one or two words
//   that hold it (the two byte orders differ only in the selectors of
//   `selectors`); a 24-bit value's low byte is then cleared.
// - Rows whose payload is not whole groups (N not a multiple of G) and
//   storage not 16-byte aligned take the same kernel with element-wise
//   loads, masked at the row's end, and element-wise stores. The run-time
//   channel path loads value by value and stores a channel's 4 bins as one
//   16-byte piece where the rows allow it.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// bins of every channel a thread owns at channel count cc (0: a count with
// no path of its own); tests/test_torch_trunc_unpack.py reads this line
__host__ __device__ constexpr int group_bins(int cc) { return cc == 8 ? 2 : 4; }

// __byte_perm selectors of a value: bits 16: halves 0 and 1 of a word
// (s0, s1); bits 24: value r of the four that three words hold, from the
// word holding its first byte and the next (s0 .. s3); bits 32: one word
// (s0). tests/test_torch_trunc_unpack.py reads these lines and models the
// values with them.
struct Sel { unsigned int s0, s1, s2, s3; };

__device__ __forceinline__ Sel selectors(int bits, bool little) {
    if (bits == 16) return little ? Sel{0x4410u, 0x4432u, 0u, 0u} : Sel{0x4401u, 0x4423u, 0u, 0u};
    if (bits == 24) return little ? Sel{0x2100u, 0x5430u, 0x4320u, 0x3210u} : Sel{0x0120u, 0x3450u, 0x2340u, 0x1230u};
    return little ? Sel{0x3210u, 0u, 0u, 0u} : Sel{0x0123u, 0u, 0u, 0u};
}

// the float of bit depth BITS from payload word a (and the next word b,
// for a 24-bit value) with selector s; NaN and Inf become +0.0
template <int BITS>
__device__ __forceinline__ float value(unsigned int a, unsigned int b, unsigned int s) {
    float x;
    if (BITS == 16)
        x = __half2float(__ushort_as_half((unsigned short)__byte_perm(a, 0u, s)));
    else if (BITS == 24)
        x = __uint_as_float(__byte_perm(a, b, s) & 0xffffff00u);
    else
        x = __uint_as_float(__byte_perm(a, 0u, s));
    return isfinite(x) ? x : 0.0f;
}

// the W payload words of a group that starts at byte `first` of its frame
// (word k's little-endian bytes are the group's bytes 4k .. 4k + 3): in the
// widest pieces that divide them (VEC launches), or element by element
// (int16 elements at 16 bits, else int32), 0 from the row's end (`row`
// bytes) on
template <int BITS, int W, bool VEC>
__device__ __forceinline__ void load_words(unsigned int (&w)[W], const uint8_t* __restrict__ frame,
                                           int first, int row) {
    if (VEC) {
        vio::load(w, reinterpret_cast<const unsigned int*>(frame + first));
    } else if (BITS == 16) {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(frame + first);
        const int left = (row - first) >> 1;
        unsigned short h[2 * W];
#pragma unroll
        for (int i = 0; i < 2 * W; ++i) h[i] = i < left ? __ldg(e + i) : (unsigned short)0;
#pragma unroll
        for (int k = 0; k < W; ++k) w[k] = (unsigned int)h[2 * k] | ((unsigned int)h[2 * k + 1] << 16);
    } else {
        const unsigned int* e = reinterpret_cast<const unsigned int*>(frame + first);
        const int left = (row - first) >> 2;
#pragma unroll
        for (int k = 0; k < W; ++k) w[k] = k < left ? __ldg(e + k) : 0u;
    }
}

// the group's V values in payload order from its words: value k is half k
// % 2 of word k / 2 (16 bits); value r = k % 4 of the quad of words 3(k /
// 4) .. 3(k / 4) + 2, from the word holding its first byte, j = 3r / 4, and
// word j + 1 (24 bits); word k (32 bits)
template <int BITS, int V>
__device__ __forceinline__ void unpack_group(const unsigned int (&w)[V * BITS / 32], Sel s,
                                             float (&v)[V]) {
    if (BITS == 16) {
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
            v[2 * k] = value<16>(w[k], 0u, s.s0);
            v[2 * k + 1] = value<16>(w[k], 0u, s.s1);
        }
    } else if (BITS == 24) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
            const unsigned int a = w[3 * q], b = w[3 * q + 1], c = w[3 * q + 2];
            v[4 * q] = value<24>(a, b, s.s0);
            v[4 * q + 1] = value<24>(a, b, s.s1);
            v[4 * q + 2] = value<24>(b, c, s.s2);
            v[4 * q + 3] = value<24>(c, 0u, s.s3);
        }
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = value<32>(w[k], 0u, s.s0);
    }
}

// value m of a frame, element by element (the run-time channel path)
template <int BITS>
__device__ __forceinline__ float value_at(const uint8_t* __restrict__ frame, int m, Sel s) {
    if (BITS == 16)
        return value<16>(__ldg(reinterpret_cast<const unsigned short*>(frame) + m), 0u, s.s0);
    if (BITS == 32)
        return value<32>(__ldg(reinterpret_cast<const unsigned int*>(frame) + m), 0u, s.s0);
    const unsigned int* quad = reinterpret_cast<const unsigned int*>(frame) + 3 * (m >> 2);
    const int r = m & 3;
    const int j = (3 * r) >> 2;
    const unsigned int sel = r == 0 ? s.s0 : r == 1 ? s.s1 : r == 2 ? s.s2 : s.s3;
    return value<24>(__ldg(quad + j), r == 3 ? 0u : __ldg(quad + j + 1), sel);
}

// G bins of one channel row from bin t0 on (bins from n on dropped)
template <int G>
__device__ __forceinline__ void store_bins(float* __restrict__ row, const float (&r)[G], int t0,
                                           int n, bool vec) {
    if (vec) {
        vio::store(row + t0, r);
    } else {
#pragma unroll
        for (int j = 0; j < G; ++j)
            if (t0 + j < n) row[t0 + j] = r[j];
    }
}

// CC: the channel count (1, 2 or 8), or 0 for any (run-time path)
template <int CC, int BITS, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
trunc_unpack_kernel(const uint8_t* __restrict__ in, float* __restrict__ out, int channels, int n,
                    int little) {
    constexpr int BPV = BITS / 8;
    constexpr int G = group_bins(CC);
    const int C = CC ? CC : channels;
    const int t0 = ((int)blockIdx.y * (int)blockDim.x + (int)threadIdx.x) * G;
    if (t0 >= n) return;
    const int M = C * n;
    const uint8_t* frame = in + (long long)blockIdx.x * M * BPV;
    float* dst = out + (long long)blockIdx.x * M;
    const Sel s = selectors(BITS, little != 0);
    if constexpr (CC != 0) {
        constexpr int V = G * CC;
        unsigned int w[V * BITS / 32];
        load_words<BITS, V * BITS / 32, VEC>(w, frame, t0 * CC * BPV, M * BPV);
        float v[V];
        unpack_group<BITS, V>(w, s, v);
#pragma unroll
        for (int c = 0; c < CC; ++c) {
            float r[G];
#pragma unroll
            for (int j = 0; j < G; ++j) r[j] = v[j * CC + c];
            store_bins(dst + c * n, r, t0, n, VEC);
        }
    } else {
        for (int c = 0; c < C; ++c) {
            float r[G];
#pragma unroll
            for (int j = 0; j < G; ++j) r[j] = value_at<BITS>(frame, min(t0 + j, n - 1) * C + c, s);
            store_bins(dst + c * n, r, t0, n, VEC);
        }
    }
}

template <int CC, int BITS>
void launch(dim3 grid, int threads, bool vec, cudaStream_t s, const uint8_t* in, float* out,
            int C, int N, int little) {
    if (vec)
        trunc_unpack_kernel<CC, BITS, true><<<grid, threads, 0, s>>>(in, out, C, N, little);
    else
        trunc_unpack_kernel<CC, BITS, false><<<grid, threads, 0, s>>>(in, out, C, N, little);
}

template <int BITS>
void dispatch(dim3 grid, int threads, bool vec, cudaStream_t s, const uint8_t* in, float* out,
              int C, int N, int little) {
    if (C == 1) launch<1, BITS>(grid, threads, vec, s, in, out, C, N, little);
    else if (C == 2) launch<2, BITS>(grid, threads, vec, s, in, out, C, N, little);
    else if (C == 8) launch<8, BITS>(grid, threads, vec, s, in, out, C, N, little);
    else launch<0, BITS>(grid, threads, vec, s, in, out, C, N, little);
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

// chunks (blocks a frame) and threads (a block) come from
// kernels/trunc_unpack.py:geometry; any values that cover a frame's groups
// are correct.
extern "C" int frad_trunc_unpack(const void* in, float* out, int B, int C, int N, int bits,
                                 int little, int chunks, int threads, void* stream) {
    if (B <= 0 || C <= 0 || N <= 0) return 0;
    const int G = group_bins(C == 1 || C == 2 || C == 8 ? C : 0);
    if ((long long)C * N * 4 > 0x7fffffffLL || (bits != 16 && bits != 24 && bits != 32)
        || (bits == 24 && (C * N) % 4 != 0) || chunks < 1 || chunks > 65535
        || threads < 32 || threads > MAX_THREADS || threads % 32 != 0
        || (long long)chunks * threads * G < N)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)B, (unsigned int)chunks);
    const bool vec = N % G == 0 && aligned(in, 16) && aligned(out, 16);
    cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* p = (const uint8_t*)in;
    if (bits == 16) dispatch<16>(grid, threads, vec, s, p, out, C, N, little);
    else if (bits == 24) dispatch<24>(grid, threads, vec, s, p, out, C, N, little);
    else dispatch<32>(grid, threads, vec, s, p, out, C, N, little);
    return (int)cudaGetLastError();
}
