// Shared definitions of the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_build.py): it launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define VIT_API extern "C" __attribute__((visibility("default")))

namespace vit {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// 16 x 16 x 16 tensor-core tiles, bf16 operands, fp32 accumulators
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// round to bf16 and back: the rounding points of the TPU kernels
__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// 16 x 16 x 16 int8 tensor-core tiles, int32 accumulators.  The int8
// wmma kernels (K12-K14) keep their operands in the "k16" layout: an R x K
// matrix is stored as K/16 slices of R rows of 16 contiguous codes, so a
// fragment (16 rows x 16 codes) is 256 contiguous bytes, 32-byte aligned,
// ldm 16.
using FragA8 = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                              wmma::row_major>;
using FragB8 = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                              wmma::col_major>;
using FragC32 = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// index of element (r, k) of an R-row matrix in the k16 layout
__device__ __forceinline__ int k16_index(int r, int k, int R) {
    return (k >> 4) * (R * 16) + r * 16 + (k & 15);
}

// the int8 envelope of the JAX package (geglu_ff._quant_rows): scale =
// max(amax, 1e-8) / 127; code = clip(round_half_even(y / scale), ±127).
// The divide is IEEE (y / s, never y * (1/s)), the rounding rintf.
__device__ __forceinline__ float quant_scale(float amax) {
    return __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
}
__device__ __forceinline__ signed char quant8(float y, float s) {
    return (signed char)fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

}  // namespace vit
