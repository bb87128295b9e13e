// Profile 2's order-12 Levinson-Durbin recursion for one lane, the only
// source of it on the card: csrc/tns_fir_gate.cu runs it in one thread of
// each row's block.
//
// The port of the XLA device program `_levinson` of
// frad_python_tpu/ops/tns_jax.py (an unrolled chain of ~400 masked vector
// ops): autocorrelation lags ac [13] -> LPC coefficients lpc [13]:
//
//   lpc = [1, 0, ...]; error = ac[0]; dead = frozen = error <= 1e-10
//   for i = 1 .. 12:
//     acc   = sum_{j=0..i-1} lpc[j] * ac[i-j]          (j ascending)
//     refl  = -acc / (error == 0 ? 1 : error), clamped to +-0.96
//     upd   = lpc; upd[i] = refl; upd[j] += refl * lpc[i-j]  (1 <= j < i)
//     lpc   = frozen ? lpc : upd
//     error = frozen ? error : error * (1 - refl^2)
//     frozen |= error <= 1e-12
//   dead lanes return [1, 0, ...]
//
// A scalar chain with data-dependent freezing: ~250 operations, every loop
// fully unrolled so that the 13 lags and 13 coefficients stay in
// registers, the clamp and the freeze written as selects (no branch).
// Every product, sum, difference and quotient is the IEEE-rounded
// intrinsic, so nvcc contracts nothing into an FMA and the recursion is
// bit-identical to the eager PyTorch version
// (frad_python_tpu_torch/kernels/tns_levinson.py:tns_levinson_plain).

#pragma once

#include "tns_reduce.cuh"

namespace tns {

template <typename T>
__device__ __forceinline__ void levinson(const T (&ac)[ORDER1], T (&lpc)[ORDER1]) {
#pragma unroll
    for (int j = 0; j < ORDER1; ++j) lpc[j] = (T)0;
    lpc[0] = (T)1;
    T error = ac[0];
    const bool dead = error <= (T)1e-10;
    bool frozen = dead;
    const T lim = (T)0.96;

#pragma unroll
    for (int i = 1; i < ORDER1; ++i) {
        T acc = (T)0;
#pragma unroll
        for (int j = 0; j < i; ++j) acc = add_rn(acc, mul_rn(lpc[j], ac[i - j]));
        const T safe_err = error == (T)0 ? (T)1 : error;
        T refl = div_rn(-acc, safe_err);
        refl = refl >= lim ? lim : (refl <= -lim ? -lim : refl);

        T upd[ORDER1];
#pragma unroll
        for (int j = 0; j < ORDER1; ++j) upd[j] = lpc[j];
        upd[i] = refl;
#pragma unroll
        for (int j = 1; j < i; ++j) upd[j] = add_rn(lpc[j], mul_rn(refl, lpc[i - j]));
        const T new_err = mul_rn(error, sub_rn((T)1, mul_rn(refl, refl)));
#pragma unroll
        for (int j = 0; j < ORDER1; ++j) lpc[j] = frozen ? lpc[j] : upd[j];
        error = frozen ? error : new_err;
        frozen = frozen || (error <= (T)1e-12);
    }

    if (dead) {
#pragma unroll
        for (int j = 0; j < ORDER1; ++j) lpc[j] = j == 0 ? (T)1 : (T)0;
    }
}

}  // namespace tns
