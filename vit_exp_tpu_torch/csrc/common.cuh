// Shared definitions of the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_build.py): it launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VIT_API extern "C" __attribute__((visibility("default")))

namespace vit {

using bf16 = __nv_bfloat16;

// round to bf16 and back: the rounding points of the TPU kernels
__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
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

// 8 codes of one scale, packed
__device__ __forceinline__ uint2 quant8x8(const float (&v)[8], float s) {
    uint2 out;
    signed char* o = reinterpret_cast<signed char*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = quant8(v[i], s);
    return out;
}

// let kernel take `bytes` of dynamic shared memory (above 48 KB)
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

}  // namespace vit
