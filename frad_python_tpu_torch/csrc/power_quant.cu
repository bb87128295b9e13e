// power_quant: the Profile 1 encoder's quantisation epilogue on Hopper.
//
// Replaces the Pallas kernel `power_quant` (`_quant_kernel`) of
// frad_python_tpu/research/pallas_kernels.py, in the JAX product's sqrt
// form (frad_python_tpu/ops/psycho.py:quant_jnp):
//
//   q = div == 0 ? 0 : rint(sign(x) * sqrt(|x| * sqrt(|x|))),  x = f / div * factor
//
// over [R, N] float32 inputs (R = frames * channels) into int32.
//
// Bound: bytes. Each element reads 8 bytes and writes 4 for a handful of
// flops, far below the card's flop-per-byte balance, so the kernel runs
// at memory bandwidth at best. Design: one thread per element, neighbouring
// threads on neighbouring elements along N, so every load and store of a
// warp is one coalesced 128-byte transaction; no shared memory, nothing
// kept between elements. Division and square roots are the IEEE-rounded
// intrinsics and rounding is round-half-even (__float2int_rn, not
// roundf), so the result is bit-identical to the eager PyTorch version
// (frad_python_tpu_torch/kernels/power_quant.py:power_quant_plain).
// Vectorised 16-byte loads and fusing into the DCT GEMM's epilogue are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void power_quant_kernel(const float* __restrict__ freqs,
                                   const float* __restrict__ div,
                                   int32_t* __restrict__ out,
                                   long long n, float factor) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float d = div[i];
    int32_t q = 0;
    if (d != 0.0f) {
        float x = __fmul_rn(__fdiv_rn(freqs[i], d), factor);
        float a = fabsf(x);
        float m = __fsqrt_rn(__fmul_rn(a, __fsqrt_rn(a)));
        float s = x > 0.0f ? m : (x < 0.0f ? -m : 0.0f);
        q = __float2int_rn(s);
    }
    out[i] = q;
}

}  // namespace

extern "C" int frad_power_quant(const float* freqs, const float* div,
                                int32_t* out, long long n, float factor,
                                void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    power_quant_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(freqs, div, out, n, factor);
    return (int)cudaGetLastError();
}
