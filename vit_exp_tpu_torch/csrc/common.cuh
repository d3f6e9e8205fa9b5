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
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// round to bf16 and back: the rounding points of the TPU kernels
__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

}  // namespace vit
