// egr_pack: Profile 1's Exp-Golomb-Rice bit-packer and word compaction on
// Hopper.
//
// Replaces the XLA device programs of the JAX package
// (frad_python_tpu/ops/bitpack.py:egr_pack_frames and the compaction of
// frad_python_tpu/parallel/pipeline.py:_egr_compact_packer, fused there in
// _p1_enc_egr_fused). Per row (one frame's interleaved symbols):
//
//   dmax = max |s|;  k = bitlen(max(dmax - 1, 0))
//   mapped = s > 0 ? 2s - 1 : -2s;  v = mapped + 2^k
//   blen = bitlen(v);  code length = 2 blen - k - 1  (blen - k - 1 zeros,
//   then v's blen bits); codes follow one another, big-endian bit order
//   inside 32-bit words, zero padding after the last code
//   total_bits = sum of code lengths; overflow = total_bits > 32 max_words;
//   used = overflow ? 0 : ceil(total_bits / 32)
//
// then each row's used words are copied to the exclusive prefix sum of
// `used` in one flat buffer. The words equal the host EGR coder's bytes
// (ops/golomb.py) and the plain version's
// (kernels/egr_pack.py:egr_pack_plain) word for word on every row that does
// not overflow; an overflowing row's words are not valid in either, and no
// symbol of it is written past its row.
//
// Bound: bytes (4 in, ~1.5 out per symbol; a dozen integer operations).
// Design: the XLA program scatter-adds two word contributions per symbol
// into the whole [B, max_words] buffer; here one block owns a row and walks
// it in tiles of blockDim symbols. A tile's codes cover a contiguous bit
// range, so the tile ORs its contributions (atomicOr: two symbols may share
// a word, never a bit) into a shared-memory window of at most WINDOW words,
// whatever the row's length, then stores the window's whole words coalesced
// and carries the last partial word into the next tile. Bit lengths are
// 64 - clz, exact. Three launches (pack; one block's scan of `used`; copy)
// on the caller's stream behind one C entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// a code is at most k + 3 <= 35 bits: a tile spans at most THREADS * 35
// bits, plus the carried partial word and the last partial word
constexpr int WINDOW = THREADS * 35 / 32 + 3;

__device__ __forceinline__ unsigned int abs_u32(int s) {
    return s < 0 ? 0u - (unsigned int)s : (unsigned int)s;
}

// bits [blo, bhi) of v's code that land in word w, placed big-endian
__device__ __forceinline__ unsigned int word_contrib(unsigned long long v, long long start,
                                                     long long end, long long w) {
    const long long lo = w << 5;
    const long long blo = start > lo ? start : lo;
    const long long bhi = end < lo + 32 ? end : lo + 32;
    const unsigned long long chunk = (v >> (end - bhi)) & ((1ull << (bhi - blo)) - 1ull);
    return (unsigned int)((chunk << (lo + 32 - bhi)) & 0xFFFFFFFFull);
}

// inclusive scan of x over the block; `warp_sums` holds THREADS / 32 values
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int s = lane < THREADS / 32 ? warp_sums[lane] : 0;
        for (int d = 1; d < THREADS / 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
            if (lane >= d) s += y;
        }
        if (lane < THREADS / 32) warp_sums[lane] = s;
    }
    __syncthreads();
    const int out = x + (warp > 0 ? warp_sums[warp - 1] : 0);
    *total = warp_sums[THREADS / 32 - 1];
    __syncthreads();                      // warp_sums is reused by the next tile
    return out;
}

__global__ void __launch_bounds__(THREADS)
egr_pack_kernel(const int* __restrict__ symbols, unsigned int* __restrict__ words,
                int* __restrict__ used, int* __restrict__ total_bits, int* __restrict__ ks,
                int* __restrict__ overflow, int M, int max_words) {
    __shared__ unsigned int win[WINDOW];
    __shared__ int warp_sums[THREADS / 32];
    __shared__ unsigned int warp_max[THREADS / 32];
    const int row = blockIdx.x, tid = threadIdx.x;
    const int* s_row = symbols + (long long)row * M;
    unsigned int* w_row = words + (long long)row * max_words;

    // (a) the row's Rice parameter from max |s|
    unsigned int m = 0;
    for (int i = tid; i < M; i += THREADS) m = max(m, abs_u32(s_row[i]));
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    unsigned int dmax = 0;
    for (int i = 0; i < THREADS / 32; i++) dmax = max(dmax, warp_max[i]);
    const int k = dmax <= 1u ? 0 : 32 - __clz(dmax - 1u);

    // (b, c) tiles of THREADS symbols: code lengths, their scan, the window
    long long bits = 0;                   // stream bits before this tile
    unsigned int carry = 0;               // the partial word the last tile left
    for (int t0 = 0; t0 < M; t0 += THREADS) {
        for (int i = tid; i < WINDOW; i += THREADS) win[i] = i == 0 ? carry : 0u;
        const int i = t0 + tid;
        unsigned long long v = 0;
        int blen = 0, len = 0;
        if (i < M) {
            const int s = s_row[i];
            const unsigned long long a = abs_u32(s);
            v = (s > 0 ? 2ull * a - 1ull : 2ull * a) + (1ull << k);
            blen = 64 - __clzll((long long)v);
            len = 2 * blen - k - 1;
        }
        int tile_bits;
        const int incl = block_scan(len, warp_sums, &tile_bits);   // syncs: win is zeroed
        const long long base = bits >> 5;
        if (i < M) {
            const long long end = bits + incl, start = end - blen;
            const long long w0 = start >> 5, w1 = (end - 1) >> 5;
            if (w0 < max_words) atomicOr(&win[w0 - base], word_contrib(v, start, end, w0));
            if (w1 > w0 && w1 < max_words)
                atomicOr(&win[w1 - base], word_contrib(v, start, end, w1));
        }
        __syncthreads();
        bits += tile_bits;
        const int whole = (int)((bits >> 5) - base);
        for (int j = tid; j < whole; j += THREADS)
            if (base + j < max_words) w_row[base + j] = win[j];
        carry = win[whole];
        __syncthreads();
    }

    // (d) the last partial word, zero padding up to max_words, the row's sums
    const long long n_words = (bits + 31) >> 5;
    if (tid == 0 && (bits & 31) != 0 && (bits >> 5) < max_words) w_row[bits >> 5] = carry;
    for (long long j = n_words + tid; j < max_words; j += THREADS) w_row[j] = 0u;
    if (tid == 0) {
        const int ovf = bits > (long long)max_words * 32;
        total_bits[row] = (int)bits;
        ks[row] = k;
        overflow[row] = ovf;
        used[row] = ovf ? 0 : (int)n_words;
    }
}

// offs[i] = sum of used[0 .. i), offs[B] = the sum of all: one block
__global__ void __launch_bounds__(1024)
egr_offsets_kernel(const int* __restrict__ used, long long* __restrict__ offs, int B) {
    __shared__ long long warp_sums[32];
    __shared__ long long running;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) running = 0;
    __syncthreads();
    for (int t0 = 0; t0 < B; t0 += 1024) {
        const int i = t0 + tid;
        const long long u = i < B ? used[i] : 0;
        long long x = u;
        for (int d = 1; d < 32; d <<= 1) {
            const long long y = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[warp] = x;
        __syncthreads();
        if (warp == 0) {
            long long s = warp_sums[lane];
            for (int d = 1; d < 32; d <<= 1) {
                const long long y = __shfl_up_sync(0xFFFFFFFFu, s, d);
                if (lane >= d) s += y;
            }
            warp_sums[lane] = s;
        }
        __syncthreads();
        const long long incl = running + x + (warp > 0 ? warp_sums[warp - 1] : 0);
        if (i < B) offs[i] = incl - u;
        __syncthreads();
        if (tid == 1023) running = incl;
        __syncthreads();
    }
    if (tid == 0) offs[B] = running;
}

__global__ void __launch_bounds__(THREADS)
egr_compact_kernel(const unsigned int* __restrict__ words, const int* __restrict__ used,
                   const long long* __restrict__ offs, unsigned int* __restrict__ flat,
                   int max_words) {
    const int row = blockIdx.x;
    const unsigned int* src = words + (long long)row * max_words;
    unsigned int* dst = flat + offs[row];
    const int n = used[row];
    for (int j = threadIdx.x; j < n; j += THREADS) dst[j] = src[j];
}

}  // namespace

// symbols [B, M] int32 -> words [B, max_words], meta [4, B] int32 (rows:
// used, total_bits, k, overflow), offs [B + 1] int64, flat [B * max_words]
// (its first offs[B] words are the compacted stream)
extern "C" int frad_egr_pack(const int* symbols, unsigned int* words, int* meta,
                             long long* offs, unsigned int* flat, int B, int M,
                             int max_words, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    egr_pack_kernel<<<B, THREADS, 0, s>>>(symbols, words, meta, meta + B, meta + 2 * B,
                                          meta + 3 * B, M, max_words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    egr_offsets_kernel<<<1, 1024, 0, s>>>(meta, offs, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    egr_compact_kernel<<<B, THREADS, 0, s>>>(words, meta, offs, flat, max_words);
    return (int)cudaGetLastError();
}
