// Short runs of elements moved as whole vectors: a run of K elements of one
// type is loaded or stored in the widest pieces (16, 8, 4 or 2 bytes) that
// divide its size, so a thread that owns V bins of every channel of an
// interleaved [.., C] row moves them in one or two 16-byte accesses
// (dequant.cu, overlap_add.cu). The caller guarantees the alignment: the
// run's address is a multiple of the piece width.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vio {

template <int W>
struct Piece;
template <>
struct Piece<16> { using type = uint4; };
template <>
struct Piece<8> { using type = uint2; };
template <>
struct Piece<4> { using type = unsigned int; };
template <>
struct Piece<2> { using type = unsigned short; };

// the widest piece that divides a run of `bytes`
constexpr int piece_width(int bytes) {
    return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

// a run of K elements of E as pieces
template <typename E, int K>
struct Pieces {
    static constexpr int W = piece_width(K * (int)sizeof(E));
    static constexpr int COUNT = K * (int)sizeof(E) / W;
    using P = typename Piece<W>::type;
    union U {
        P p[COUNT];
        E e[K];
    };
};

// K elements from src through the read-only cache
template <typename E, int K>
__device__ __forceinline__ void load(E (&d)[K], const E* __restrict__ src) {
    using R = Pieces<E, K>;
    typename R::U u;
#pragma unroll
    for (int i = 0; i < R::COUNT; ++i)
        u.p[i] = __ldg(reinterpret_cast<const typename R::P*>(src) + i);
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = u.e[k];
}

// K elements to dst
template <typename E, int K>
__device__ __forceinline__ void store(E* __restrict__ dst, const E (&s)[K]) {
    using R = Pieces<E, K>;
    typename R::U u;
#pragma unroll
    for (int k = 0; k < K; ++k) u.e[k] = s[k];
#pragma unroll
    for (int i = 0; i < R::COUNT; ++i) reinterpret_cast<typename R::P*>(dst)[i] = u.p[i];
}

}  // namespace vio
