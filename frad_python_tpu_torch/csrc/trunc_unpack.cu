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
//   a NaN or Inf becomes 0 (the reference decoder's scrub)
//
// Input is the payload's byte stream (the int16 / int32 words the host
// uploads, little-endian), output the float32 [B, C, N] tensor the IDCT
// GEMM reads, so the transpose is folded into the kernel.
//
// Bound: bytes. Each output value reads 2-4 bytes and writes 4 with a few
// integer operations. Design: one thread per output element, t fastest,
// so a warp's float32 stores run along N and coalesce; its byte loads
// stride by the channel count. Vector loads are later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void trunc_unpack_kernel(const uint8_t* __restrict__ in,
                                    float* __restrict__ out,
                                    int B, int C, int N, int bits, int little) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)B * C * N;
    if (i >= total) return;
    const int t = (int)(i % N);
    const long long bc = i / N;
    const int c = (int)(bc % C);
    const long long b = bc / C;
    const int bpv = bits / 8;
    const uint8_t* p = in + (b * C * N + (long long)t * C + c) * bpv;
    float x;
    if (bits == 16) {
        const unsigned short h = little ? (unsigned short)(p[0] | (p[1] << 8))
                                        : (unsigned short)((p[0] << 8) | p[1]);
        x = __half2float(__ushort_as_half(h));
    } else {
        unsigned int u;
        if (bits == 24) {
            u = little ? ((unsigned int)p[0] << 8) | ((unsigned int)p[1] << 16)
                             | ((unsigned int)p[2] << 24)
                       : ((unsigned int)p[0] << 24) | ((unsigned int)p[1] << 16)
                             | ((unsigned int)p[2] << 8);
        } else {
            u = little ? (unsigned int)p[0] | ((unsigned int)p[1] << 8)
                             | ((unsigned int)p[2] << 16) | ((unsigned int)p[3] << 24)
                       : ((unsigned int)p[0] << 24) | ((unsigned int)p[1] << 16)
                             | ((unsigned int)p[2] << 8) | (unsigned int)p[3];
        }
        x = __uint_as_float(u);
    }
    out[i] = isfinite(x) ? x : 0.0f;
}

}  // namespace

extern "C" int frad_trunc_unpack(const void* in, float* out, int B, int C, int N,
                                 int bits, int little, void* stream) {
    const long long n = (long long)B * C * N;
    if (n <= 0) return 0;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    trunc_unpack_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, out, B, C, N, bits, little);
    return (int)cudaGetLastError();
}
