// overlap_add: the lossy decoders' overlap-add and PCM emit on Hopper.
//
// Replaces the Pallas kernel `crossfade_frames` (`_crossfade_kernel`) of
// frad_python_tpu/research/pallas_kernels.py and widens it to all of
// frad_python_tpu/models/batch.py:overlap_add_core plus the s16 emit and
// fragment slice of `_p1_decode_oa_jit`:
//
//   out[b, t, c] = pcm[b, c, t]                                   b == 0 or t >= olap
//                = pcm[b, c, t] * w[t] + pcm[b-1, c, cut+t] * w[olap-1-t]   b >= 1, t < olap
//   out         -> clamp(rint(out * 32768), -32768, 32767) as int16 when i16
//   frag[t, c]  = pcm[B-1, c, cut+t]                               (raw)
//
// Input is the IDCT output in its [B, C, N] layout; output is [B, cut, C]
// interleaved, so the transpose is folded into the kernel. float32, or
// float64 (pcm, w, frag and the float emit) for the float64 compute path.
//
// Bound: bytes. Each output element reads one or two floats and writes
// 2 or 4 bytes, with a few flops. Design: one thread per element, t
// fastest, so a warp's loads run along N and coalesce (two channel
// streams per warp when C == 2); the fragment is a few extra threads at
// the end of the same grid, so one launch does the whole emit. The blend
// uses __fmul_rn / __fadd_rn (__dmul_rn / __dadd_rn): nvcc would otherwise contract it into an
// FMA and round differently from eager PyTorch, and the kernel is held
// bit-identical to frad_python_tpu_torch/kernels/overlap_add.py:
// overlap_add_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float clamp_s16(float r) { return fminf(fmaxf(r, -32768.0f), 32767.0f); }
__device__ __forceinline__ double clamp_s16(double r) { return fmin(fmax(r, -32768.0), 32767.0); }

template <typename T>
__global__ void overlap_add_kernel(const T* __restrict__ pcm,
                                   const T* __restrict__ w,
                                   void* __restrict__ out,
                                   T* __restrict__ frag,
                                   int B, int C, int N, int olap, int cut,
                                   int i16) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long n_out = (long long)B * C * cut;
    if (i < n_out) {
        int t = (int)(i % cut);
        long long bc = i / cut;
        int c = (int)(bc % C);
        int b = (int)(bc / C);
        T x = pcm[bc * N + t];
        if (b > 0 && t < olap) {
            T prev = pcm[(bc - C) * N + cut + t];
            x = add_rn(mul_rn(x, w[t]), mul_rn(prev, w[olap - 1 - t]));
        }
        long long o = ((long long)b * cut + t) * C + c;
        if (i16) {
            T r = rint_t(mul_rn(x, (T)32768));
            ((int16_t*)out)[o] = (int16_t)clamp_s16(r);
        } else {
            ((T*)out)[o] = x;
        }
        return;
    }
    long long j = i - n_out;
    if (j < (long long)C * olap) {
        int t = (int)(j % olap);
        int c = (int)(j / olap);
        frag[(long long)t * C + c] = pcm[((long long)(B - 1) * C + c) * N + cut + t];
    }
}

}  // namespace

extern "C" int frad_overlap_add(const void* pcm, const void* w, void* out,
                                void* frag, int B, int C, int N, int olap,
                                int cut, int i16, int is_f64, void* stream) {
    long long n = (long long)B * C * cut + (long long)C * olap;
    if (n <= 0) return 0;
    const int threads = 256;
    unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64)
        overlap_add_kernel<double><<<blocks, threads, 0, s>>>(
            (const double*)pcm, (const double*)w, out, (double*)frag, B, C, N,
            olap, cut, i16);
    else
        overlap_add_kernel<float><<<blocks, threads, 0, s>>>(
            (const float*)pcm, (const float*)w, out, (float*)frag, B, C, N,
            olap, cut, i16);
    return (int)cudaGetLastError();
}
