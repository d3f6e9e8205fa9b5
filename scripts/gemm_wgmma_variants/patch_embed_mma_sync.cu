// The patch embedding's design before Hopper (PR 10): an implicit GEMM on
// mma.sync m16n8k16 fed by ldmatrix from a cp.async ring, the video staged
// in 8-byte pieces into token rows once per 256-column tile, the statistics
// as mma products of the A fragments with a B of ones.  Kept for
// scripts/gemm_wgmma_trial.py --variants (stage PE) beside the shipped
// csrc/patch_embed.cu, with the mma.sync pieces it used (once
// csrc/gemm_mma.cuh) inlined below; built alone with -I csrc, it exports the
// same C entry points.
//
// K4 and the patch-embed product: the fused patch embedding.  Replaces
// vit_exp_tpu/ops/patches.py::_stats_kernel (_patch_stats_pallas, K4) and the
// strided product _conv_f32 beside it, with the LayerNorm fix-up of
// fused_patch_embed (patches.py:155-253):
//   token[d] = (Σ_k x_k·kc[d, k] − μ·csum[d])·inv + dvec[d],
//   μ = Σx / n, inv = rsqrt(max(Σbf16(x²) / n − μ², 0) + eps)
// over the patch of n = CPT·p1·p2 voxels of each token, in one pass over
// the video: the patch tensor, an fp32 copy of the video and the fp32
// product never reach device memory.
//
// x: (BT, CPT, H, W) bf16; token (bt, hi, wi) owns the window
// x[bt, :, hi·p1 .., wi·p2 ..].  An implicit GEMM: M = tokens, N = D, K = n
// in the reference feature order k = (ch·p1 + r)·p2 + j.  kc: (D, n) bf16,
// rows of n (index-major for ldmatrix).  Output bf16
// (BT, H/p1, W/p2, D) with D a multiple of 16 (the column tiles past D are
// zero-filled, their columns never written), and μ and Σbf16(x²), fp32
// (BT, H/p1, W/p2), written
// by the blocks of the first column tile.
//
// What bounds it at batch 4 (x 442 MB, n 4,000, 55,296 tokens, D 768): the
// 340 GFLOP of the product on the bf16 tensor cores (0.343 ms at 989
// TFLOP/s) more than its 533 MB (0.159 ms at 3.35 TB/s).  The design:
// - A block of 16 warps (2 × 8, warp tiles of 48 × 32) owns PE_TOKENS
//   token rows made of whole patch rows of tokens (tg = PE_TOKENS / ws of
//   them, ws = W / p2; 4 × 24 = 96 at production, never straddling a frame)
//   and PE_COLS = 256 output columns (D 768: three column tiles; a D that
//   is not a multiple of 256 leaves the last tile's upper warps idle).  The
//   column tiles of one token tile are neighbours in the grid, so the video
//   is read from device memory about once and re-read from L2.
// - A k step is R whole patch rows (R·p2 a multiple of 16: R 4, 80 deep at
//   p2 20); where CPT·p1 is not a multiple of R (100 patch rows of 8 at the
//   planted arch's p1 = p2 = 10 and CPT 10) the last step's rows past
//   CPT·p1 are zero-filled, as are kc's columns past n.  A token's row segment of p2 bf16 is not 16-byte aligned for odd
//   wi, so one 16-byte copy cannot place it: a warp copies a video row in
//   8-byte pieces (4-byte where p2 % 4 != 0), coalesced, each to its
//   token's row of the A tile, which is then an ordinary index-major
//   operand tile (rows of 16·KS + 8 bf16) for ldmatrix, beside kc's tile,
//   in a PE_STAGES-deep cp.async ring.  mma.sync m16n8k16, fp32
//   accumulators in registers.
// - The statistics come from the A fragments on the tensor cores: warp
//   column w multiplies m16 tile w's fragment, and its square rounded to
//   bf16 (one bf16x2 multiply), by a B of ones, fp32 accumulators again.
//   No extra load of the video, and two mma per k16 slice for one warp.
// - The epilogue applies the fix-up on the accumulators in the twin's
//   order, without FMA contraction, stages each warp's tile in shared
//   memory and writes it as 16-byte row pieces.
// A tile trial and ablations (PR 10) put its
// time in the staging of the video rows (each column tile stages them
// again) and of kc's tiles, more than in the products; 256 columns and 16
// warps a block won over 128 columns and 8 warps.
// ---- the mma.sync pieces (once csrc/gemm_mma.cuh) ----
// The mma.sync pieces of the patch embedding (patch_embed.cu), which stages
// its own operand tiles in a loop of its own; every other product runs on
// gemm_wgmma.cuh:
// acc[m, n] += Σ_k A(m, k) · B(k, n) in bf16 with fp32 accumulators
// (mma.sync m16n8k16), the accumulators in registers.
//
// - Operands are row-major bf16 matrices in device memory (Mat), stored
//   index-major, (index, k): A as M × K, B as N × K.  Rows and columns past
//   a Mat's ends, or at or past k_end, are zero-filled by cp.async.  The
//   contiguous extent, the row pitch and every tile origin along it must be
//   multiples of 16 bytes (8 bf16), and the pointer 16-byte aligned.
// - An operand tile of IDX rows × BK of depth is staged as it is stored,
//   each row padded by 16 bytes, so the 8 row addresses of an ldmatrix fall
//   on 8 distinct 16-byte bank groups.
// - WM × WN warps; warp (wm, wn) owns rows wm·WTM .. and columns wn·WTN ..
//   of the block tile: MT m16 × NT n8 accumulator tiles in mma.sync's C
//   layout (lane l, g = l / 4, t = l % 4: rows g and g + 8, columns 2t and
//   2t + 1), which the caller's epilogue reads in place.
#include "attn_mma.cuh"

namespace vit {

// a row-major bf16 matrix: element (r, c) at p[r · ld + c], r < rows, c <
// cols
struct Mat {
    const bf16* p;
    long long ld;
    int rows, cols;
};

// one operand's tile of IDX (output rows or columns) × BK (depth), staged
// as it is stored, [IDX][BK], each row padded by 16 bytes (VEC elements)
template <int IDX, int BK>
struct OperandTile {
    static constexpr int VEC = 8;   // a 16-byte chunk
    static constexpr int LD = BK + VEC;
    static constexpr int ELEMS = IDX * LD;
    static constexpr int CHUNKS = IDX * BK / VEC;

    // the tile at index i0 and depth k0 of m, zero where k ≥ k_end
    template <int THREADS>
    __device__ __forceinline__ static void load(bf16* dst, const Mat& m,
                                                int i0, int k0, int k_end,
                                                int tid) {
        const int c_end = min(m.cols, k_end);
#pragma unroll
        for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
            const int e = tid + i * THREADS;
            if (CHUNKS % THREADS == 0 || e < CHUNKS) {
                const int r = e / (BK / VEC), c = (e % (BK / VEC)) * VEC;
                const bool ok = i0 + r < m.rows && k0 + c < c_end;
                cp_async16(dst + r * LD + c,
                           ok ? m.p + (long long)(i0 + r) * m.ld + k0 + c : m.p,
                           ok);
            }
        }
    }
};

// the A fragment (m16 × 16 b16 of depth) at tile offsets (mi, ki), mma.sync's
// A layout; LD and ki in b16 units
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int mi, int ki, int lane) {
    ldsm_x4(a, s + (mi + (lane & 15)) * LD + ki + ((lane >> 4) << 3));
}

// the B fragments of two n8 tiles (16 b16 of depth × n16 at tile offsets
// ni, ki): {b0, b1} of columns ni .. ni + 7, then of ni + 8 .. ni + 15
template <int LD>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const bf16* s,
                                        int ni, int ki, int lane) {
    ldsm_x4(b, s + (ni + (lane & 7) + ((lane >> 4) << 3)) * LD + ki +
                   (lane & 8));
}

// a block tile of BM × BN on WM × WN warps, k steps of BK, STAGES stages
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct GemmCfg {
    static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
    static constexpr int STAGES = STAGES_;
    static constexpr int THREADS = WM * WN * 32;
    static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
    static constexpr int MT = WTM / 16, NT = WTN / 8;
    using TA = OperandTile<BM, BK>;
    using TB = OperandTile<BN, BK>;
    static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0,
                  "warp tiles of m16 × n16 steps, k16 steps");
};

// the row of accumulator element e of m16 tile mt within the block tile,
// for the warp and lane that hold it
template <class C>
__device__ __forceinline__ int acc_row(int mt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / C::WN) * C::WTM + mt * 16 + (e >> 1) * 8 + (lane >> 2);
}

}  // namespace vit

// ---- the kernel ----

using namespace vit;

namespace {

// the tile line
constexpr int PE_COLS = 256, PE_STAGES = 3;
constexpr int PE_WN = 8, PE_BLOCKS = 1;
constexpr int PE_TOKENS = 96, PE_WM = 2;
constexpr int PE_ROW_COPIES = 5;   // W ≤ 32·5·4 = 640 bf16 (p2 % 4 == 0)

// the tiling of a step of KS k16 slices (k depth 16·KS)
template <int KS>
using PeCfg = GemmCfg<PE_TOKENS, PE_COLS, 16 * KS, PE_WM, PE_WN, PE_STAGES>;

struct PeArgs {
    const bf16* x;
    const bf16* kc;
    const float* csum;
    const float* dvec;
    bf16* out;
    float* mu;
    float* sq;
    int CPT, H, W, p1, p2, D, n;
    int hs, ws, groups;   // groups: BT·hs rows of patches
    int tg, R, log2R, n_steps, patch_rows;   // patch_rows: CPT·p1
    float nf, eps;
};

// CB bytes global → shared (4 or 8: .ca takes both); zero-fill when !valid
template <int CB>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(CB), "r"(valid ? CB : 0)
                 : "memory");
}

// x² of two bf16, each product rounded once to bf16 (as bf16_round(x·x))
__device__ __forceinline__ uint32_t sq_bf16x2(uint32_t v) {
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
    b = __hmul2(b, b);
    return *reinterpret_cast<uint32_t*>(&b);
}

constexpr uint32_t ONES_BF16X2 = 0x3f803f80u;   // two bf16 1.0

// grid (⌈D / PE_COLS⌉, ⌈groups / tg⌉); dynamic shared memory: PE_STAGES ×
// (PE_TOKENS + PE_COLS) rows of 16·KS + 8 bf16, or the epilogue's if more.
// CB: the bytes of one copy, 8 where p2 % 4 == 0 (a token's patch-row
// segment is 8-byte aligned), else 4; a staged video row of W bf16 takes at
// most 32·PE_ROW_COPIES copies
template <int KS, int CB>
__global__ void __launch_bounds__(PeCfg<KS>::THREADS, PE_BLOCKS)
patch_embed_kernel(const PeArgs a) {
    using C = PeCfg<KS>;
    using TA = OperandTile<PE_TOKENS, 16 * KS>;
    constexpr int BK = C::BK, MT = C::MT, NT = C::NT, NW = C::THREADS / 32;
    constexpr int EPC = CB / 2;   // bf16 of one copy
    static_assert(MT <= C::WN, "one warp column per m16 tile's statistics");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wq = warp % C::WN;   // warp column: the m16 tile whose
                                   // statistics it sums
    const int wm = (warp / C::WN) * C::WTM, wn = wq * C::WTN;
    const int n0 = blockIdx.x * C::BN;
    const int g0 = blockIdx.y * a.tg;   // first row of patches of the tile
    const int a_rows = a.tg * a.R;      // video rows a step needs
    const int row_copies = a.W / EPC;   // copies of one video row
    constexpr int STAGE = TA::ELEMS + C::TB::ELEMS;
    const Mat kc{a.kc, a.n, a.D, a.n};

    // where copy lane + 32u of a video row lands in a token row of the A
    // tile: token (lane + 32u)·EPC / p2, depth of its patch row's piece
    int dst[PE_ROW_COPIES];
#pragma unroll
    for (int u = 0; u < PE_ROW_COPIES; ++u) {
        const int e = (lane + 32 * u) * EPC, wi = e / a.p2;
        dst[u] = wi * TA::LD + (e - wi * a.p2);
    }

    auto issue = [&](int step) {
        if (step < a.n_steps) {
            bf16* stage = smem + (step % C::STAGES) * STAGE;
            // one warp per video row (gi, ρ), patch row step·R + ρ: its W
            // bf16 are the ρ-th patch-row pieces of the ws tokens of row gi
            for (int row = warp; row < a_rows; row += NW) {
                const int gi = row >> a.log2R, rho = row & (a.R - 1);
                const int grp = g0 + gi, pr = step * a.R + rho;
                const bool ok = grp < a.groups && pr < a.patch_rows;
                const int bt = grp / a.hs, hi = grp - bt * a.hs;
                const int ch = pr / a.p1, r = pr - ch * a.p1;
                const bf16* src =
                    a.x + (((size_t)bt * a.CPT + ch) * a.H +
                           (size_t)hi * a.p1 + r) * a.W;
                bf16* d = stage + gi * a.ws * TA::LD + rho * a.p2;
#pragma unroll
                for (int u = 0; u < PE_ROW_COPIES; ++u) {
                    const int c = lane + 32 * u;
                    if (c < row_copies)
                        cp_async_small<CB>(d + dst[u],
                                           ok ? src + c * EPC : a.x, ok);
                }
            }
            C::TB::template load<C::THREADS>(stage + TA::ELEMS, kc, n0,
                                             step * BK, a.n, tid);
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    // Σx and Σbf16(x²) of m16 tile wq's rows on the tensor cores: the A
    // fragment and its square times a B of ones; every column holds the
    // row's sum (st[0][0]: row g, st[0][2]: row g + 8)
    float st[2][4] = {};

#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) issue(s);
    for (int step = 0; step < a.n_steps; ++step) {
        cp_async_wait<C::STAGES - 2>();   // this thread's copies of the step
        __syncthreads();   // every copy visible; the oldest stage is free
        issue(step + C::STAGES - 1);
        const bf16* sa = smem + (step % C::STAGES) * STAGE;
        const bf16* sb = sa + TA::ELEMS;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
            uint32_t af[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                frag_a<TA::LD>(af[mt], sa, wm + mt * 16, s * 16, lane);
                if (mt == wq) {
                    const uint32_t a2[4] = {
                        sq_bf16x2(af[mt][0]), sq_bf16x2(af[mt][1]),
                        sq_bf16x2(af[mt][2]), sq_bf16x2(af[mt][3])};
                    mma(st[0], af[mt], ONES_BF16X2, ONES_BF16X2);
                    mma(st[1], a2, ONES_BF16X2, ONES_BF16X2);
                }
            }
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bfr[4];
                frag_b2<C::TB::LD>(bfr, sb, wn + np * 16, s * 16, lane);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
                    mma(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: it holds the statistics now

    // red[row]: Σx of the block's token row, red[PE_TOKENS + row]: Σx²
    float* red = reinterpret_cast<float*>(smem_raw);
    if (wq < MT && (lane & 3) == 0) {
        const int row = wm + wq * 16 + (lane >> 2);
        red[row] = st[0][0];
        red[row + 8] = st[0][2];
        red[PE_TOKENS + row] = st[1][0];
        red[PE_TOKENS + row + 8] = st[1][2];
    }
    __syncthreads();
    // the statistics of block row i: (μ, Σx², inv)
    auto stats = [&](int i, float& m, float& q, float& inv) {
        q = red[PE_TOKENS + i];
        m = __fdiv_rn(red[i], a.nf);
        const float var = fmaxf(
            __fsub_rn(__fdiv_rn(q, a.nf), __fmul_rn(m, m)), 0.f);
        inv = rsqrtf(__fadd_rn(var, a.eps));
    };
    // the token of block row i, or −1 past the tile's patch rows or the end
    auto token = [&](int i) {
        const int gi = i / a.ws;
        return gi < a.tg && g0 + gi < a.groups
                   ? (g0 + gi) * a.ws + (i - gi * a.ws) : -1;
    };
    if (blockIdx.x == 0)
        for (int i = tid; i < PE_TOKENS; i += C::THREADS) {
            const int m = token(i);
            if (m < 0) continue;
            float mu, q, inv;
            stats(i, mu, q, inv);
            a.mu[m] = mu;
            a.sq[m] = q;
        }

    // token = (y − μ·csum)·inv + dvec on the accumulators, staged per warp
    // in shared memory (after red) and written as 16-byte row pieces; a
    // warp whose columns lie past D (the last column tile of a D that is
    // not a multiple of PE_COLS) has nothing to write, and one that
    // straddles D writes the 8-column pieces below it (D % 16 == 0)
    if (n0 + wn >= a.D) return;
    constexpr int LDO = C::WTN + 8;   // bf16: a warp's 8 rows hit 8 banks
    bf16* so = reinterpret_cast<bf16*>(smem_raw + 2 * PE_TOKENS * 4) +
               warp * C::WTM * LDO;
    float rm[MT][2], ri[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float q;
            stats(acc_row<C>(mt, 2 * half), rm[mt][half], q, ri[mt][half]);
        }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int cl = nt * 8 + 2 * (lane & 3);   // in the warp's tile
        const bool in = n0 + wn + cl < a.D;       // D even: both columns
        const float2 cs =
            in ? *reinterpret_cast<const float2*>(a.csum + n0 + wn + cl)
               : make_float2(0.f, 0.f);
        const float2 dv =
            in ? *reinterpret_cast<const float2*>(a.dvec + n0 + wn + cl)
               : make_float2(0.f, 0.f);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const float* y = acc[mt][nt] + 2 * half;
                const float mu = rm[mt][half], iv = ri[mt][half];
                const float t0 = __fadd_rn(
                    __fmul_rn(__fsub_rn(y[0], __fmul_rn(mu, cs.x)), iv), dv.x);
                const float t1 = __fadd_rn(
                    __fmul_rn(__fsub_rn(y[1], __fmul_rn(mu, cs.y)), iv), dv.y);
                store_bf16x2(so + (mt * 16 + half * 8 + (lane >> 2)) * LDO + cl,
                             t0, t1);
            }
    }
    __syncwarp();
    constexpr int ROW_CHUNKS = C::WTN / 8;   // 16-byte pieces of a row
    for (int c = lane; c < C::WTM * ROW_CHUNKS; c += 32) {
        const int rl = c / ROW_CHUNKS, cc = (c - rl * ROW_CHUNKS) * 8;
        const int m = token(wm + rl);
        if (m >= 0 && n0 + wn + cc < a.D)
            *reinterpret_cast<uint4*>(a.out + (size_t)m * a.D + n0 + wn + cc) =
                *reinterpret_cast<const uint4*>(so + rl * LDO + cc);
    }
}

template <int KS, int CB>
int launch(const PeArgs& a, int smem, void* stream) {
    cudaError_t e = allow_smem(patch_embed_kernel<KS, CB>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a.D + PE_COLS - 1) / PE_COLS, (a.groups + a.tg - 1) / a.tg);
    patch_embed_kernel<KS, CB><<<grid, PeCfg<KS>::THREADS, smem,
                                 (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

int gcd(int u, int v) { return v ? gcd(v, u % v) : u; }

}  // namespace

// the dynamic shared memory of a launch on these shapes, or 0 if the kernel
// does not take them: bf16 video rows of W % 8 == 0, an even p2 whose k step
// is 16, 32, 48 or 80 deep (R·p2 with R = 16 / gcd(p2, 16)), at most
// PE_TOKENS tokens per patch row, n = CPT·p1·p2 a multiple of 8 (kc's rows
// of 16-byte pieces), D a multiple of 16, and at most 227 KB of shared
// memory
VIT_API int vit_patch_embed_check(int BT, int CPT, int H, int W, int p1,
                                  int p2, int D) {
    if (BT < 1 || CPT < 1 || p1 < 1 || H < p1 || H % p1 || p2 < 2 ||
        p2 % 2 || W < p2 || W % p2 || W % 8 || D < 16 || D % 16)
        return 0;
    const int ws = W / p2, R = 16 / gcd(p2, 16), ks = R * p2 / 16;
    if (ws > PE_TOKENS || (ks != 1 && ks != 2 && ks != 3 && ks != 5) ||
        (CPT * p1 * p2) % 8)
        return 0;
    if (W > 32 * PE_ROW_COPIES * (p2 % 4 ? 2 : 4)) return 0;
    // the ring, then (reused) the statistics and the warps' out tiles
    const int ring =
        PE_STAGES * (PE_TOKENS + PE_COLS) * (16 * ks + 8) * (int)sizeof(bf16);
    const int epilogue = 2 * PE_TOKENS * (int)sizeof(float) +
                         PE_WM * PE_WN * (PE_TOKENS / PE_WM) *
                             (PE_COLS / PE_WN + 8) * (int)sizeof(bf16);
    const int smem = ring > epilogue ? ring : epilogue;
    return smem <= 227 * 1024 ? smem : 0;
}

VIT_API int vit_patch_embed_fwd(const void* x, const void* kc,
                                const void* csum, const void* dvec, void* out,
                                void* mu, void* sq, int BT, int CPT, int H,
                                int W, int p1, int p2, int D, float eps,
                                void* stream) {
    const int smem = vit_patch_embed_check(BT, CPT, H, W, p1, p2, D);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int R = 16 / gcd(p2, 16);
    PeArgs a;
    a.x = (const bf16*)x;
    a.kc = (const bf16*)kc;
    a.csum = (const float*)csum;
    a.dvec = (const float*)dvec;
    a.out = (bf16*)out;
    a.mu = (float*)mu;
    a.sq = (float*)sq;
    a.CPT = CPT;
    a.H = H;
    a.W = W;
    a.p1 = p1;
    a.p2 = p2;
    a.D = D;
    a.n = CPT * p1 * p2;
    a.hs = H / p1;
    a.ws = W / p2;
    a.groups = BT * a.hs;
    a.tg = PE_TOKENS / a.ws;
    a.R = R;
    a.log2R = __builtin_ctz(R);
    a.patch_rows = CPT * p1;
    a.n_steps = (a.patch_rows + R - 1) / R;
    a.nf = (float)a.n;
    a.eps = eps;
    if (p2 % 4) switch (R * p2 / 16) {   // p2 2, 6, 10: k steps 16, 48, 80
            case 1: return launch<1, 4>(a, smem, stream);
            case 3: return launch<3, 4>(a, smem, stream);
            default: return launch<5, 4>(a, smem, stream);
        }
    switch (R * p2 / 16) {
        case 1: return launch<1, 8>(a, smem, stream);
        case 2: return launch<2, 8>(a, smem, stream);
        case 3: return launch<3, 8>(a, smem, stream);
        default: return launch<5, 8>(a, smem, stream);
    }
}
