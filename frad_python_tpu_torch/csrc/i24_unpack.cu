// i24_unpack: int24 fixed-point words -> float32 PCM, the transfer form of
// the Profile 0 encoder's upload (3 bytes a sample).
//
// Replaces the XLA device program `i24_words_to_pcm_device` of
// frad_python_tpu/ops/bitpack.py. Words [B, W] int32 hold the samples'
// 3-byte little-endian serialisation; three words give four values
//
//   x = sign_extend_24(t) * 2^-23
//
// pcm [B, W * 4 / 3] float32. The conversion of a 24-bit integer and the
// multiply by a power of two are exact, so the result equals the plain
// version's (frad_python_tpu_torch/kernels/i24_unpack.py:i24_unpack_plain)
// bit for bit.
//
// Bound: bytes, 3 in and 4 out a sample (18.5 MB at [645, 2048, 2]:
// 5.5 us). Design: W % 3 == 0, so the tensor is one run of three-word
// groups; a thread takes one group (12 bytes) and writes its four floats
// as one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float unfix24(unsigned int t) {
    const int v = (int)((t & 0xFFFFFFu) ^ 0x800000u) - 0x800000;
    return __fmul_rn(__int2float_rn(v), 1.0f / 8388608.0f);
}

__global__ void __launch_bounds__(THREADS)
i24_unpack_kernel(const unsigned int* __restrict__ words, float* __restrict__ pcm,
                  long long groups, int aligned) {
    const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (g >= groups) return;
    const unsigned int* w = words + g * 3;
    const unsigned int w0 = w[0], w1 = w[1], w2 = w[2];
    float4 o;
    o.x = unfix24(w0);
    o.y = unfix24((w0 >> 24) | (w1 << 8));
    o.z = unfix24((w1 >> 16) | (w2 << 16));
    o.w = unfix24(w2 >> 8);
    if (aligned) {
        reinterpret_cast<float4*>(pcm)[g] = o;
    } else {
        float* p = pcm + g * 4;
        p[0] = o.x, p[1] = o.y, p[2] = o.z, p[3] = o.w;
    }
}

}  // namespace

extern "C" int frad_i24_unpack(const void* words, void* pcm, long long n_words, void* stream) {
    const long long groups = n_words / 3;
    if (groups <= 0) return 0;
    const int aligned = (reinterpret_cast<uintptr_t>(pcm) & 15) == 0;
    const long long blocks = (groups + THREADS - 1) / THREADS;
    i24_unpack_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned int*)words, (float*)pcm, groups, aligned);
    return (int)cudaGetLastError();
}
