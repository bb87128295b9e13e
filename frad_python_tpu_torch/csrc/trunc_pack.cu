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
// Bound: bytes. Each value is read once (4 bytes) and written as 2-4
// bytes with a few integer operations. Design: one block per frame, its
// threads striding over the frame's values in output order, so stores run
// along the payload; the max is an unsigned max of the bits of |x| (for
// non-negative floats the bit order is the value order, and a NaN's bits
// order above inf, so a NaN frame reports NaN as jnp.max does) reduced in
// shared memory, so no atomics and no zeroed output are needed. Loads
// stride by the channel count (two streams for stereo). Vector loads and
// word stores are later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void trunc_pack_kernel(const float* __restrict__ y,
                                  uint8_t* __restrict__ out,
                                  float* __restrict__ maxabs,
                                  int C, int N, int bits, int little) {
    const int b = blockIdx.x;
    const long long m_total = (long long)C * N;
    const int bpv = bits / 8;
    const float* frame = y + (long long)b * m_total;
    uint8_t* dst = out + (long long)b * m_total * bpv;
    unsigned int mx = 0u;
    for (long long m = threadIdx.x; m < m_total; m += blockDim.x) {
        const int t = (int)(m / C);
        const int c = (int)(m % C);
        const float x = frame[(long long)c * N + t];
        mx = max(mx, __float_as_uint(fabsf(x)));
        uint8_t* p = dst + m * bpv;
        if (bits == 16) {
            const unsigned int h = __half_as_ushort(__float2half_rn(x));
            if (little) { p[0] = (uint8_t)h; p[1] = (uint8_t)(h >> 8); }
            else { p[0] = (uint8_t)(h >> 8); p[1] = (uint8_t)h; }
        } else {
            const unsigned int u = __float_as_uint(x);
            if (bits == 24) {
                if (little) { p[0] = (uint8_t)(u >> 8); p[1] = (uint8_t)(u >> 16);
                              p[2] = (uint8_t)(u >> 24); }
                else { p[0] = (uint8_t)(u >> 24); p[1] = (uint8_t)(u >> 16);
                       p[2] = (uint8_t)(u >> 8); }
            } else if (little) {
                p[0] = (uint8_t)u; p[1] = (uint8_t)(u >> 8);
                p[2] = (uint8_t)(u >> 16); p[3] = (uint8_t)(u >> 24);
            } else {
                p[0] = (uint8_t)(u >> 24); p[1] = (uint8_t)(u >> 16);
                p[2] = (uint8_t)(u >> 8); p[3] = (uint8_t)u;
            }
        }
    }
    __shared__ unsigned int red[kThreads];
    red[threadIdx.x] = mx;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] = max(red[threadIdx.x], red[threadIdx.x + s]);
        __syncthreads();
    }
    if (threadIdx.x == 0) maxabs[b] = __uint_as_float(red[0]);
}

}  // namespace

extern "C" int frad_trunc_pack(const float* y, void* out, float* maxabs, int B, int C,
                               int N, int bits, int little, void* stream) {
    if (B <= 0) return 0;
    trunc_pack_kernel<<<(unsigned int)B, kThreads, 0, (cudaStream_t)stream>>>(
        y, (uint8_t*)out, maxabs, C, N, bits, little);
    return (int)cudaGetLastError();
}
