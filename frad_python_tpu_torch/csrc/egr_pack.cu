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
// then each row's used words lie at the exclusive prefix sum of `used` in
// one flat buffer. The words equal the host EGR coder's bytes
// (ops/golomb.py) and the plain version's
// (kernels/egr_pack.py:egr_pack_plain) word for word on every row that does
// not overflow; an overflowing row's words are not valid in either, and
// nothing of it is written.
//
// Bound: bytes (4 in, ~1.5 out per symbol; a dozen integer operations):
// 4.0 us at [688, 4096]. Design: two launches (three for large batches)
// on the caller's stream behind one C entry, and no padded intermediate
// in device memory.
//
// 1. lengths: a block a row reads the symbols as 16-byte loads, takes
//    max |s| and from it k, reads them again (they are in L1) and sums
//    the code lengths: total_bits, used, k, overflow.
// 2. offsets: one block's scan of `used`, for batches of more than
//    SUM_ROWS rows only. Up to there each pack block sums the `used` of
//    the rows before its own instead (at most SUM_ROWS / THREADS loads a
//    thread from L2 and one barrier), which saves the launch (1.8 us on
//    an H100, where the pack then takes 10 us at [688, 4096]).
// 3. pack: a block a row writes the words straight to the row's offset
//    in the flat buffer (the symbols' second read comes from L2). The
//    block takes the row in chunks of THREADS * RUN symbols. A thread
//    owns RUN consecutive symbols, read as 16-byte loads straight from
//    global memory (staging the chunk coalesced through shared memory
//    first measured slower at [688, 4096] on an H100), so the block
//    scans one total a thread, once a chunk: three barriers for 4096
//    symbols, where a tile of one symbol a thread took six for 256. The
//    thread's codes land in rising words, so it gathers one 32-bit word
//    at a time in a register and ORs it into a shared-memory window of
//    the chunk when the next word begins (atomicOr: the first and the last
//    word of a run can be shared with a neighbour): ~7 shared atomics for
//    16 symbols, not 32, and no loop whose length depends on the data.
//    The window's whole words are stored coalesced and its last partial
//    word is carried into the next chunk.
//
// Two passes over the symbols, chosen over one pass with a look-back over
// rows: the rows' offsets depend on every earlier row's length, the second
// read of 11.3 MB comes from the 50 MB L2, and an overflowing row is
// known before anything of it is written. With `words` given (the padded
// form), the pack also writes each row zero-padded to max_words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 256 threads of 16 symbols: of the splits of a 4096-symbol chunk tried
// on an H100 (512 x 8, 384 x 12, 256 x 8) the fastest at [688, 4096]
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUM_ROWS = 2048;            // batches up to here need no scan launch
constexpr int RUN = 16;                   // symbols a thread owns in a chunk
constexpr int CHUNK = THREADS * RUN;
// a code is at most k + 3 <= 35 bits: a chunk spans at most CHUNK * 35
// bits, plus the carried partial word and the last partial word
constexpr int WINDOW = CHUNK * 35 / 32 + 3;

__device__ __forceinline__ unsigned int abs_u32(int s) {
    return s < 0 ? 0u - (unsigned int)s : (unsigned int)s;
}

__device__ __forceinline__ int rice_k(unsigned int dmax) {
    return dmax <= 1u ? 0 : 32 - __clz(dmax - 1u);
}

// v = mapped + 2^k of one symbol, and its bit length: every |s| of the row
// is at most dmax <= 2^k, so mapped <= 2^(k+1) and v has k + 1 bits where
// mapped < 2^k and k + 2 bits otherwise (the code k + 1 or k + 3). V is
// unsigned int for rows of k <= NARROW_K, whose v stay under 2^31, and
// unsigned long long for the rest (v < 2^33): 64-bit integer operations
// take two machine operations or more each, and a row the caller sizes at 12
// bits a symbol overflows from k = 12 on.
constexpr int NARROW_K = 29;

template <typename V>
__device__ __forceinline__ int code_blen(int s, int k, V* v) {
    const V a = abs_u32(s);
    const V mapped = s > 0 ? 2 * a - 1 : 2 * a;
    *v = mapped + ((V)1 << k);
    return k + 1 + ((mapped >> k) != 0);
}

// v's blen bits behind bit `off` of a 32-bit word: `hi` is that word's
// share, `lo` the next word's (0 unless off + blen > 32)
__device__ __forceinline__ void place(unsigned int v, int off, int blen, unsigned int* hi,
                                      unsigned int* lo) {
    const int s = off + blen - 32;
    *hi = s > 0 ? v >> s : v << -s;
    *lo = s > 0 ? v << (32 - s) : 0u;
}

__device__ __forceinline__ void place(unsigned long long v, int off, int blen, unsigned int* hi,
                                      unsigned int* lo) {
    const unsigned long long p = v << (64 - off - blen);
    *hi = (unsigned int)(p >> 32);
    *lo = (unsigned int)p;
}

// symbols [i0, i0 + RUN) of a row of M into `sym` (0 past the row's end);
// 16-byte loads where `vec` says the row allows them
__device__ __forceinline__ void load_run(const int* __restrict__ s_row, int i0, int M, bool vec,
                                         int* sym) {
    if (vec && i0 + RUN <= M) {
        const int4* p = reinterpret_cast<const int4*>(s_row + i0);
#pragma unroll
        for (int q = 0; q < RUN / 4; ++q) {
            const int4 a = p[q];
            sym[4 * q] = a.x, sym[4 * q + 1] = a.y, sym[4 * q + 2] = a.z, sym[4 * q + 3] = a.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j) sym[j] = i0 + j < M ? s_row[i0 + j] : 0;
    }
}

__device__ __forceinline__ bool row_vectorises(const int* s_row, int M) {
    return (M & 3) == 0 && (reinterpret_cast<uintptr_t>(s_row) & 15) == 0;
}

// this thread's share of a row's code lengths (2 blen - k - 1 each)
template <typename V>
__device__ __forceinline__ long long row_bits(const int* __restrict__ s_row, int M, int k,
                                              bool vec) {
    long long bits = 0;
    V v;
    if (vec) {
        const int4* p = reinterpret_cast<const int4*>(s_row);
        for (int i = threadIdx.x; i < M / 4; i += THREADS) {
            const int4 a = p[i];
            bits += 2 * (code_blen(a.x, k, &v) + code_blen(a.y, k, &v) + code_blen(a.z, k, &v)
                         + code_blen(a.w, k, &v)) - 4 * (k + 1);
        }
    } else {
        for (int i = threadIdx.x; i < M; i += THREADS)
            bits += 2 * code_blen(s_row[i], k, &v) - k - 1;
    }
    return bits;
}

__global__ void __launch_bounds__(THREADS)
egr_lengths_kernel(const int* __restrict__ symbols, int* __restrict__ used,
                   int* __restrict__ total_bits, int* __restrict__ ks,
                   int* __restrict__ overflow, int M, int max_words) {
    __shared__ unsigned int warp_max[WARPS];
    __shared__ long long warp_sum[WARPS];
    const int row = blockIdx.x, tid = threadIdx.x;
    const int* s_row = symbols + (long long)row * M;
    const bool vec = row_vectorises(s_row, M);

    // the row's Rice parameter from max |s|
    unsigned int m = 0;
    if (vec) {
        const int4* p = reinterpret_cast<const int4*>(s_row);
        for (int i = tid; i < M / 4; i += THREADS) {
            const int4 a = p[i];
            m = max(max(m, abs_u32(a.x)), max(max(abs_u32(a.y), abs_u32(a.z)), abs_u32(a.w)));
        }
    } else {
        for (int i = tid; i < M; i += THREADS) m = max(m, abs_u32(s_row[i]));
    }
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    unsigned int dmax = 0;
#pragma unroll
    for (int i = 0; i < WARPS; i++) dmax = max(dmax, warp_max[i]);
    const int k = rice_k(dmax);

    long long bits = k <= NARROW_K ? row_bits<unsigned int>(s_row, M, k, vec)
                                   : row_bits<unsigned long long>(s_row, M, k, vec);
    for (int d = 16; d > 0; d >>= 1) bits += __shfl_down_sync(0xFFFFFFFFu, bits, d);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = bits;
    __syncthreads();
    if (tid == 0) {
        long long total = 0;
#pragma unroll
        for (int i = 0; i < WARPS; i++) total += warp_sum[i];
        const int ovf = total > (long long)max_words * 32;
        total_bits[row] = (int)total;
        ks[row] = k;
        overflow[row] = ovf;
        used[row] = ovf ? 0 : (int)((total + 31) >> 5);
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

// one row's words into dst (and w_row, where not null) through the window
template <typename V>
__device__ __forceinline__ void pack_row(const int* __restrict__ s_row, int M, int k,
                                         unsigned int* __restrict__ dst,
                                         unsigned int* __restrict__ w_row, unsigned int* win,
                                         int* warp_sums) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool vec = row_vectorises(s_row, M);
    long long bits = 0;                   // stream bits before this chunk
    unsigned int carry = 0;               // the partial word the last chunk left
    // a code is at most k + 3 bits: the words a chunk can reach
    const int reach = min(WINDOW, (CHUNK * (k + 3) >> 5) + 3);
    for (int c0 = 0; c0 < M; c0 += CHUNK) {
        for (int i = tid; i < reach; i += THREADS) win[i] = i == 0 ? carry : 0u;
        int sym[RUN];
        const int i0 = c0 + tid * RUN;
        const int n_sym = min(max(M - i0, 0), RUN);
        load_run(s_row, i0, M, vec, sym);

        // this thread's bits, and where they start in the chunk
        V v;
        int mine = 0;
#pragma unroll
        for (int j = 0; j < RUN; ++j)
            if (j < n_sym) mine += 2 * code_blen(sym[j], k, &v) - k - 1;
        int incl = mine;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
            if (lane >= d) incl += y;
        }
        if (lane == 31) warp_sums[warp] = incl;
        __syncthreads();                  // warp_sums are in; win is zeroed
        int before = 0, chunk_bits = 0;
#pragma unroll
        for (int i = 0; i < WARPS; i++) {
            before += i < warp ? warp_sums[i] : 0;
            chunk_bits += warp_sums[i];
        }

        // Bit positions count from the window's first word. v's blen <= 33
        // bits start at bit start & 31 of word w0 and end in w0 or w0 + 1
        // (`place`). The run's words come in rising order, so one word at
        // a time gathers in `acc` and goes out when the next begins;
        // another thread may hold the rest of a word, so every word goes
        // in by atomicOr.
        int pos = (int)(bits & 31) + before + incl - mine;
        int cur = pos >> 5;
        unsigned int acc = 0;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
            if (j < n_sym) {
                const int blen = code_blen(sym[j], k, &v);
                pos += 2 * blen - k - 1;                  // the code's end
                const int start = pos - blen, w0 = start >> 5;
                unsigned int hi, lo;
                place(v, start & 31, blen, &hi, &lo);
                if (w0 != cur) {
                    atomicOr(&win[cur], acc);
                    cur = w0, acc = 0;
                }
                acc |= hi;
                if ((start & 31) + blen > 32) {
                    atomicOr(&win[cur], acc);
                    cur = w0 + 1, acc = lo;
                }
            }
        }
        if (acc) atomicOr(&win[cur], acc);
        __syncthreads();

        const int base = (int)(bits >> 5);
        bits += chunk_bits;
        const int whole = (int)(bits >> 5) - base;
        for (int j = tid; j < whole; j += THREADS) {
            dst[base + j] = win[j];
            if (w_row) w_row[base + j] = win[j];
        }
        carry = win[whole];
        __syncthreads();                  // win and warp_sums are reused by the next chunk
    }
    if (tid == 0 && (bits & 31) != 0) {
        dst[bits >> 5] = carry;
        if (w_row) w_row[bits >> 5] = carry;
    }
}

__global__ void __launch_bounds__(THREADS)
egr_pack_kernel(const int* __restrict__ symbols, const int* __restrict__ used,
                const int* __restrict__ ks, const long long* __restrict__ offs,
                unsigned int* __restrict__ flat, unsigned int* __restrict__ words,
                int M, int max_words) {
    __shared__ unsigned int win[WINDOW];
    __shared__ int warp_sums[WARPS];
    const int row = blockIdx.x;
    long long before = 0;                 // words of the rows before this one
    if (offs) {
        before = offs[row];
    } else {
        for (int i = threadIdx.x; i < row; i += THREADS) before += used[i];
        for (int d = 16; d > 0; d >>= 1) before += __shfl_down_sync(0xFFFFFFFFu, before, d);
        long long* sums = reinterpret_cast<long long*>(win);
        if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = before;
        __syncthreads();
        before = 0;
#pragma unroll
        for (int i = 0; i < WARPS; i++) before += sums[i];
        __syncthreads();                  // the window is free again
    }
    const int n_words = used[row];
    unsigned int* w_row = words ? words + (long long)row * max_words : nullptr;
    if (w_row)                            // the padded form: zeros after the row's words
        for (int j = n_words + threadIdx.x; j < max_words; j += THREADS) w_row[j] = 0u;
    if (n_words == 0) return;             // an overflowing row
    const int* s_row = symbols + (long long)row * M;
    unsigned int* dst = flat + before;
    const int k = ks[row];
    if (k <= NARROW_K)
        pack_row<unsigned int>(s_row, M, k, dst, w_row, win, warp_sums);
    else
        pack_row<unsigned long long>(s_row, M, k, dst, w_row, win, warp_sums);
}

}  // namespace

// symbols [B, M] int32 -> meta [4, B] int32 (rows: used, total_bits, k,
// overflow), flat [B * max_words] (its first sum(used) words are the
// compacted stream) and, where `words` is not null, words [B, max_words],
// each row zero-padded; offs [B + 1] int64 is scratch
extern "C" int frad_egr_pack(const int* symbols, unsigned int* words, int* meta,
                             long long* offs, unsigned int* flat, int B, int M,
                             int max_words, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    egr_lengths_kernel<<<B, THREADS, 0, s>>>(symbols, meta, meta + B, meta + 2 * B,
                                             meta + 3 * B, M, max_words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (B > SUM_ROWS) {
        egr_offsets_kernel<<<1, 1024, 0, s>>>(meta, offs, B);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    egr_pack_kernel<<<B, THREADS, 0, s>>>(symbols, meta, meta + 2 * B,
                                          B > SUM_ROWS ? offs : nullptr, flat, words, M,
                                          max_words);
    return (int)cudaGetLastError();
}
