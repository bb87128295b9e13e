// dequant: the lossy decoders' dequantiser on Hopper, the elementwise stage
// between the threshold interpolation GEMM and the inverse DCT GEMM.
//
// Replaces the pre-IDCT chain of the XLA device programs
// frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit:
//
//   out[b, c, t] = sign(x) * |x|^(4/3) / factor * div[b, c, t],
//   x = symbols[b, t, c]
//
// symbols are int16 (the exact upload of small EGR symbols, float32 compute
// only) or the compute type, float32 or float64; `div` is the per-bin
// divisor the interpolation GEMM gives, or null for Profile 2, whose TNS
// synthesis runs between the dequantiser and the multiply. The output is
// the IDCT GEMM's [B, C, N] layout, so the transpose is part of the kernel.
//
// Bound: bytes (2-8 in, 4-8 of divisor, 4-8 out per element for one pow).
// Design: one thread per output element, t fastest, so a warp's divisor
// loads and stores run along N and coalesce; its symbol loads stride by the
// channel count. The arithmetic repeats the plain version's operations one
// rounding each (kernels/dequant.py:dequant_plain): powf / pow with the
// exponent rounded to the compute type, as torch.pow does with a Python
// float; the sign as the float (x > 0) - (x < 0) times the power, so a NaN
// symbol stays NaN and a zero gives +0; an IEEE division by `factor`
// (torch on a CUDA tensor multiplies by 1 / factor instead: the same bits
// for the codec's factors, which are powers of two); an IEEE multiply.
// No fused multiply-add can form: every product is an _rn intrinsic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float pow_t(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double pow_t(double a, double e) { return pow(a, e); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename S, typename T>
__global__ void dequant_kernel(const S* __restrict__ symbols,
                               const T* __restrict__ div,      // may be null
                               T* __restrict__ out, int B, int N, int C,
                               T factor, T exponent) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)B * C * N;
    if (i >= total) return;
    const int t = (int)(i % N);
    const long long bc = i / N;
    const int c = (int)(bc % C);
    const long long b = bc / C;
    const T x = (T)symbols[(b * N + t) * C + c];
    const T sgn = (T)((x > (T)0) - (x < (T)0));
    T y = div_rn(mul_rn(sgn, pow_t(abs_t(x), exponent)), factor);
    if (div != nullptr) y = mul_rn(y, div[i]);
    out[i] = y;
}

}  // namespace

// sym_kind: 0 int16 symbols (float32 compute), 1 float32, 2 float64
extern "C" int frad_dequant(const void* symbols, const void* div, void* out, int B, int N,
                            int C, double factor, double exponent, int sym_kind,
                            void* stream) {
    const long long n = (long long)B * C * N;
    if (n <= 0) return 0;
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (sym_kind == 0)
        dequant_kernel<int16_t, float><<<blocks, threads, 0, s>>>(
            (const int16_t*)symbols, (const float*)div, (float*)out, B, N, C,
            (float)factor, (float)exponent);
    else if (sym_kind == 1)
        dequant_kernel<float, float><<<blocks, threads, 0, s>>>(
            (const float*)symbols, (const float*)div, (float*)out, B, N, C,
            (float)factor, (float)exponent);
    else
        dequant_kernel<double, double><<<blocks, threads, 0, s>>>(
            (const double*)symbols, (const double*)div, (double*)out, B, N, C,
            factor, exponent);
    return (int)cudaGetLastError();
}
