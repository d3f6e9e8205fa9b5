// K4: per-patch Σx and Σx² of the bf16 video, the statistics of the patch
// embedding's LayerNorm.  Replaces vit_exp_tpu/ops/patches.py::_stats_kernel.
//
// x: (BT, CPT, H, W) bf16, patches are (CPT, p1, p2) windows.  One block per
// row of patches (grid (H/p1, BT)): threads walk neighbouring columns, so
// every load of a video row is coalesced, and sum their column over the
// CPT·p1 rows of the patch row; the p2 column sums of each patch are then
// added in shared memory.  x² is rounded to bf16 before it is summed, as the
// TPU kernel does.  Outputs μ = Σx / n and Σx², each (BT, H/p1, W/p2) fp32.
#include "common.cuh"

using namespace vit;

__global__ void __launch_bounds__(256)
patch_stats_kernel(const bf16* __restrict__ x, float* __restrict__ mu,
                   float* __restrict__ sq, int CPT, int H, int W, int p1,
                   int p2) {
    extern __shared__ float col[];   // [0, W): Σx, [W, 2W): Σx²
    const int hi = blockIdx.x, bt = blockIdx.y;
    const int hs = H / p1, ws = W / p2;
    const bf16* base = x + (size_t)bt * CPT * H * W + (size_t)hi * p1 * W;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
        float s = 0.f, q = 0.f;
        for (int ch = 0; ch < CPT; ++ch) {
            const bf16* plane = base + (size_t)ch * H * W + c;
            for (int r = 0; r < p1; ++r) {
                float v = __bfloat162float(plane[(size_t)r * W]);
                s += v;
                q += bf16_round(v * v);
            }
        }
        col[c] = s;
        col[W + c] = q;
    }
    __syncthreads();
    const float n = (float)(CPT * p1 * p2);
    for (int wi = threadIdx.x; wi < ws; wi += blockDim.x) {
        float s = 0.f, q = 0.f;
        for (int j = 0; j < p2; ++j) {
            s += col[wi * p2 + j];
            q += col[W + wi * p2 + j];
        }
        size_t o = ((size_t)bt * hs + hi) * ws + wi;
        mu[o] = s / n;
        sq[o] = q;
    }
}

VIT_API int vit_patch_stats_fwd(const void* x, void* mu, void* sq, int BT,
                                int CPT, int H, int W, int p1, int p2,
                                void* stream) {
    size_t smem = 2 * (size_t)W * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            patch_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(H / p1, BT);
    patch_stats_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (float*)mu, (float*)sq, CPT, H, W, p1, p2);
    return (int)cudaGetLastError();
}
