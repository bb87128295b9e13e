// overlap_add: the lossy decoders' overlap-add and PCM emit on Hopper.
//
// Replaces the Pallas kernel `crossfade_frames` (`_crossfade_kernel`) of
// frad_python_tpu/research/pallas_kernels.py and widens it to all of
// frad_python_tpu/models/batch.py:overlap_add_core plus the s16 emit and
// fragment slice of `_p1_decode_oa_jit`:
//
//   out[b, t, c] = pcm[b, c, t]                                   b == 0 or t >= olap
//                = pcm[b, c, t] * w[t] + pcm[b-1, c, cut+t] * w[olap-1-t]   b >= 1, t < olap
//                = pcm[0, c, t] * w[t] + halo[c, t] * w[olap-1-t]           b == 0, t < olap,
//                                                                 with a halo
//   out         -> clamp(rint(out * 32768), -32768, 32767) as int16 when i16
//   frag[t, c]  = pcm[B-1, c, cut+t]                               (raw)
//
// Input is the IDCT output in its [B, C, N] layout; output is [B, cut, C]
// interleaved, so the transpose is folded into the kernel. float32, or
// float64 (pcm, w, frag and the float emit) for the float64 compute path.
// The optional halo [C, olap] is the raw tail of the frame before frame 0,
// held by another shard of a batch split along its frames
// (frad_python_tpu/parallel/sharded.py:overlap_add_sharded, whose
// `ppermute` brings it); without it frame 0's head passes through.
// The blend uses __fmul_rn / __fadd_rn (__dmul_rn / __dadd_rn): nvcc would
// otherwise contract it into an FMA and round differently from eager
// PyTorch, and the kernel is held bit-identical to
// frad_python_tpu_torch/kernels/overlap_add.py:overlap_add_plain.
//
// Bound: bytes, each input sample read once and each output written once
// (16.6 MB at [689, 2, 2048] with the int16 emit: 4.9 us at 3.35 TB/s; a
// halo adds its C * olap samples).
// Design:
// - A grid of (frame, chunk of cut); the last row of blocks (frame B)
//   copies the fragment, so one launch does the whole emit. Indices within
//   a block are 32-bit from one 64-bit frame base; no runtime % or / runs
//   per sample.
// - A thread owns a run of V = 16 / sizeof(T) samples and, for C = 1 or 2
//   (a template argument), all channels of it: one 16-byte load from each
//   channel row of frame b and, while t < olap, one from frame b-1's tail
//   at cut + t; the blended run leaves as one interleaved piece ([t][c]:
//   16 bytes at C = 2 with the int16 emit, two 16-byte stores with the
//   float32 emit). Odd cut or olap, other channel counts and storage not
//   16-byte aligned take element-wise loads and stores in the same kernel.
// - Few frames: narrower blocks, so that the frames spread over more SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec_io.cuh"

namespace {

// threads a block at most
constexpr int MAX_THREADS = 512;
// blocks below which the runs are spread over narrower blocks (two an SM),
// down to MIN_THREADS threads a block
constexpr long long MIN_BLOCKS = 264;
constexpr int MIN_THREADS = 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float clamp_s16(float r) { return fminf(fmaxf(r, -32768.0f), 32767.0f); }
__device__ __forceinline__ double clamp_s16(double r) { return fmin(fmax(r, -32768.0), 32767.0); }

// one output sample of the emit type O from x
template <typename O, typename T>
__device__ __forceinline__ O emit(T x) {
    if constexpr (std::is_same_v<O, int16_t>)
        return (int16_t)clamp_s16(rint_t(mul_rn(x, (T)32768)));
    else
        return x;
}

// sample t of a frame blended with the previous frame's tail sample p
template <typename T>
__device__ __forceinline__ T blend(T x, T p, const T* __restrict__ w, int olap, int t) {
    return add_rn(mul_rn(x, __ldg(w + t)), mul_rn(p, __ldg(w + olap - 1 - t)));
}

// the run at t0 of every channel: cur points at sample 0 of channel 0's row
// of this frame, rows N apart; prev at the previous frame's tail (null: no
// blend), rows P apart (N for a frame of the batch, olap for the halo); dst
// at sample 0 of the interleaved output; samples from `end` on are not
// this run's
template <typename T, typename O, int CC>
__device__ __forceinline__ void emit_run(const T* __restrict__ cur, const T* __restrict__ prev,
                                         const T* __restrict__ w, O* __restrict__ dst, int C,
                                         int N, int P, int olap, int t0, int end, bool vec) {
    constexpr int V = 16 / sizeof(T);
    if constexpr (CC > 0) {
        O o[V * CC];                                         // [j * CC + c]
#pragma unroll
        for (int c = 0; c < CC; ++c) {
            T x[V], p[V];
            if (vec) {
                vio::load(x, cur + c * N + t0);
                if (prev) vio::load(p, prev + c * P + t0);
            } else {
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    x[j] = t0 + j < end ? cur[c * N + t0 + j] : (T)0;
                    p[j] = prev && t0 + j < olap ? prev[c * P + t0 + j] : (T)0;
                }
            }
#pragma unroll
            for (int j = 0; j < V; ++j)
                o[j * CC + c] = emit<O>(prev && t0 + j < olap ? blend(x[j], p[j], w, olap, t0 + j)
                                                              : x[j]);
        }
        if (vec) {
            vio::store(dst + t0 * CC, o);
        } else {
#pragma unroll
            for (int k = 0; k < V * CC; ++k)
                if (t0 + k / CC < end) dst[t0 * CC + k] = o[k];
        }
    } else {
        for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const int t = t0 + j;
                if (t >= end) break;
                T x = cur[c * N + t];
                if (prev && t < olap) x = blend(x, prev[c * P + t], w, olap, t);
                dst[t * C + c] = emit<O>(x);
            }
        }
    }
}

template <typename T, typename O, int CC>
__global__ void __launch_bounds__(MAX_THREADS)
overlap_add_kernel(const T* __restrict__ pcm, const T* __restrict__ w,
                   const T* __restrict__ halo, O* __restrict__ out, T* __restrict__ frag, int B,
                   int channels, int N, int olap, int cut, int chunk, int vec) {
    constexpr int V = 16 / sizeof(T);
    const int C = CC ? CC : channels;
    const int b = (int)blockIdx.x;
    const int t0 = (int)blockIdx.y * chunk + V * (int)threadIdx.x;
    if (b == B) {                                            // the fragment: frame B-1's tail
        if (t0 < olap)
            emit_run<T, T, CC>(pcm + (long long)(B - 1) * C * N + cut, nullptr, w, frag, C, N,
                               N, olap, t0, olap, vec != 0);
        return;
    }
    if (t0 >= cut) return;
    const T* cur = pcm + (long long)b * C * N;
    const T* prev = t0 >= olap ? nullptr : b > 0 ? cur - (long long)C * N + cut : halo;
    emit_run<T, O, CC>(cur, prev, w, out + (long long)b * cut * C, C, N, b > 0 ? N : olap, olap,
                       t0, cut, vec != 0);
}

template <typename T, typename O>
void launch(dim3 grid, int threads, cudaStream_t s, const void* pcm, const void* w,
            const void* halo, void* out, void* frag, int B, int C, int N, int olap, int cut,
            int chunk, int vec) {
    const T* x = (const T*)pcm;
    const T* wt = (const T*)w;
    const T* h = (const T*)halo;
    if (C == 1)
        overlap_add_kernel<T, O, 1><<<grid, threads, 0, s>>>(x, wt, h, (O*)out, (T*)frag, B, C,
                                                             N, olap, cut, chunk, vec);
    else if (C == 2)
        overlap_add_kernel<T, O, 2><<<grid, threads, 0, s>>>(x, wt, h, (O*)out, (T*)frag, B, C,
                                                             N, olap, cut, chunk, vec);
    else
        overlap_add_kernel<T, O, 0><<<grid, threads, 0, s>>>(x, wt, h, (O*)out, (T*)frag, B, C,
                                                             N, olap, cut, chunk, vec);
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// halo: null, or [C, olap] in pcm's type (frame 0 is then blended with it)
extern "C" int frad_overlap_add(const void* pcm, const void* w, const void* halo, void* out,
                                void* frag, int B, int C, int N, int olap, int cut, int i16,
                                int is_f64, void* stream) {
    if ((long long)B * C * cut + (long long)C * olap <= 0) return 0;
    const int V = is_f64 ? 2 : 4;
    const int runs = (cut + V - 1) / V;
    int nthr = min(MAX_THREADS, (runs + 31) / 32 * 32);
    while (nthr > MIN_THREADS && (long long)(B + 1) * ((runs + nthr - 1) / nthr) < MIN_BLOCKS)
        nthr = max(MIN_THREADS, (nthr / 2 + 31) / 32 * 32);
    const int chunk = V * nthr;
    const dim3 grid((unsigned int)(B + 1), (unsigned int)((cut + chunk - 1) / chunk));
    const int vec = N % V == 0 && cut % V == 0 && olap % V == 0 && aligned(pcm) && aligned(out)
                    && aligned(frag) && aligned(halo);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64) {
        if (i16)
            launch<double, int16_t>(grid, nthr, s, pcm, w, halo, out, frag, B, C, N, olap, cut,
                                    chunk, vec);
        else
            launch<double, double>(grid, nthr, s, pcm, w, halo, out, frag, B, C, N, olap, cut,
                                   chunk, vec);
    } else {
        if (i16)
            launch<float, int16_t>(grid, nthr, s, pcm, w, halo, out, frag, B, C, N, olap, cut,
                                   chunk, vec);
        else
            launch<float, float>(grid, nthr, s, pcm, w, halo, out, frag, B, C, N, olap, cut,
                                 chunk, vec);
    }
    return (int)cudaGetLastError();
}
