// i24_pack: float32 PCM -> int24 fixed-point words, the transfer form of
// the Profile 0 decoder's copy back to the host (3 bytes a sample).
//
// Replaces the XLA device program `pcm_to_i24_words` of
// frad_python_tpu/ops/bitpack.py (with its `_pack_byte_triples`). Per
// sample of pcm [B, n, ch], taken in (n, ch) order:
//
//   t = clip(rint(x * 2^23), -2^23, 2^23 - 1) & 0xFFFFFF
//
// and four samples become three little-endian uint32 words (the samples'
// 3-byte little-endian serialisation), words [B, n * ch * 3 / 4]. The
// multiply and the rounding are the IEEE ones (`__fmul_rn`, `rintf`: to
// nearest, ties to even), so the words equal the plain version's
// (frad_python_tpu_torch/kernels/i24_pack.py:i24_pack_plain) bit for bit:
// +-Inf and values past +-1 clamp, and a NaN gives 0, as the plain
// version's NaN does through its integer cast.
//
// Bound: bytes, 4 in and 3 out a sample (18.5 MB at [645, 2048, 2]:
// 5.5 us); a handful of operations a sample. Design: a thread takes four
// consecutive samples and writes three words. The input is addressed
// through its strides, because the caller's PCM is a transposed view of
// the IDCT's [B, ch, n] output and a copy into (n, ch) order first would
// move every byte twice more; where the samples are contiguous and
// aligned the four come in one 16-byte load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ unsigned int fix24(float x) {
    const float v = rintf(__fmul_rn(x, 8388608.0f));
    if (v != v) return 0u;                                    // NaN
    const float c = fminf(fmaxf(v, -8388608.0f), 8388607.0f);
    return (unsigned int)(int)c & 0xFFFFFFu;
}

// m = n * ch samples a row, groups = B * m / 4; strides in elements
__global__ void __launch_bounds__(THREADS)
i24_pack_kernel(const float* __restrict__ pcm, unsigned int* __restrict__ words,
                long long groups, int m, int ch, long long sb, long long sn, long long sc,
                int contiguous) {
    const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (g >= groups) return;
    float x[4];
    if (contiguous) {
        const float4 a = reinterpret_cast<const float4*>(pcm)[g];
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    } else {
        const long long i = g * 4;
        const long long b = i / m;
        const int r = (int)(i - b * m);                       // m % 4 == 0: one row a group
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = (r + j) / ch, c = (r + j) - t * ch;
            x[j] = pcm[b * sb + t * sn + c * sc];
        }
    }
    const unsigned int t0 = fix24(x[0]), t1 = fix24(x[1]), t2 = fix24(x[2]), t3 = fix24(x[3]);
    unsigned int* w = words + g * 3;
    w[0] = t0 | (t1 << 24);
    w[1] = (t1 >> 8) | (t2 << 16);
    w[2] = (t2 >> 16) | (t3 << 8);
}

}  // namespace

extern "C" int frad_i24_pack(const void* pcm, void* words, long long rows, int m, int ch,
                             long long sb, long long sn, long long sc, void* stream) {
    const long long groups = rows * m / 4;
    if (groups <= 0) return 0;
    const int contiguous = sc == 1 && sn == ch && sb == (long long)m
                           && (reinterpret_cast<uintptr_t>(pcm) & 15) == 0;
    const long long blocks = (groups + THREADS - 1) / THREADS;
    i24_pack_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pcm, (unsigned int*)words, groups, m, ch, sb, sn, sc, contiguous);
    return (int)cudaGetLastError();
}
