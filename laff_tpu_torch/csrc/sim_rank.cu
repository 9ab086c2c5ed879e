// Fused multi-head similarity + ground-truth rank counting for Hopper.
//
// Replaces the Pallas TPU kernels of laff_tpu/ops/pallas_kernels.py:
//   sim_rank_wide_kernel  <- _sim_rank_kernel_wide (launched by fused_sim_rank,
//                            the single-gallery-block branch)
//   sim_rank_tiled_kernel <- _sim_rank_kernel (the tiled branch for galleries
//                            above the wide budget)
//
// Both compute, for every text row t, rank = 1 + #{cols scoring above the
// ground-truth column} + #{cols tying it at a larger index}, over columns
// below V. Scores are bf16 x bf16 -> f32 tile products (WMMA m16n16k16 on the
// tensor cores); the (T, V) score matrix never reaches device memory: each
// 128 x 128 tile lives in shared memory only while it is counted.
//
// What bounds it: at the MV-test3k shape (T = 59,800, V = 2,990, HD = 4,096)
// the product is 2 * T * V * HD = 1.46e12 operations, 1.5 ms at the card's
// 989 TFLOP/s bf16 peak, while the operands are 0.51 GB, 0.15 ms at 3.35 TB/s:
// the work is bound by operations. The design keeps it there by never writing
// scores out. This first version is simple rather than fast: WMMA (not wgmma),
// one shared-memory stage with no copy/compute overlap, and the text tile is
// re-read from L2 for every gallery tile.
//
// Wide branch: one block owns 128 text rows and loops over the whole gallery
// twice in one launch. Sweep 1 takes each row's ground-truth score from the
// very tile accumulation that sweep 2 counts against, so ties compare
// bit-identical values (the TPU kernel's self-consistency). Sweep 1 only
// computes gallery tiles that hold some row's ground-truth column, so it adds
// about one tile in V/128 rather than doubling the operations.
//
// Tiled branch: ground-truth scores come from a separate f32 reduction (done
// by the caller in plain torch, as the JAX package does outside its kernel),
// so the ground-truth column is excluded from the greater-count and an exact
// match always ranks 1. A 2-D grid (text tiles x gallery splits) adds its
// counts with integer atomics, which are order-independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BT = 128;        // text rows per block
constexpr int BV = 128;        // gallery rows per tile
constexpr int BK = 64;         // depth per shared-memory stage
constexpr int LDA = BK + 8;    // padded bf16 row stride of the operand tiles
constexpr int LDC = BV + 4;    // padded f32 row stride of the score tile
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (cols) of 64 x 32
constexpr int ROWS_PER_WARP = BT / (THREADS / 32);  // 16, for counting

struct Smem {
    __nv_bfloat16 a[BT * LDA];
    __nv_bfloat16 b[BV * LDA];
    float c[BT * LDC];
    float gt_score[BT];
    int gt_col[BT];
};

// Copy rows [row0, row0 + 128) x [k0, k0 + BK) of a (n, hd) bf16 matrix
// into a padded shared tile; rows past n read as zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int hd, int k0) {
    constexpr int CHUNKS = BK / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < 128 * CHUNKS; i += THREADS) {
        int r = i / CHUNKS;
        int c = (i % CHUNKS) * 8;
        int g = row0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (g < n) {
            v = *reinterpret_cast<const uint4*>(src + (size_t)g * hd + k0 + c);
        }
        *reinterpret_cast<uint4*>(dst + r * LDA + c) = v;
    }
}

// s.c <- txt[row0:row0+128] . vis[col0:col0+128]^T, f32 accumulation.
__device__ void tile_scores(const __nv_bfloat16* txt,
                            const __nv_bfloat16* vis, int t, int v, int hd,
                            int row0, int col0, Smem& s) {
    const int warp = threadIdx.x / 32;
    const int wr = (warp / 4) * 64;
    const int wc = (warp % 4) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < hd; k0 += BK) {
        load_tile(s.a, txt, row0, t, hd, k0);
        load_tile(s.b, vis, col0, v, hd, k0);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa[4];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> fb[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                wmma::load_matrix_sync(fa[i], s.a + (wr + i * 16) * LDA + kk, LDA);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], s.b + (wc + j * 16) * LDA + kk, LDA);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(s.c + (wr + i * 16) * LDC + wc + j * 16,
                                    acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
}

// Per-lane counts for the warp's 16 rows against the tile in s.c.
// exclude_gt: the tiled rule (gt column never counts as greater).
__device__ __forceinline__ void count_tile(const Smem& s, int col0, int v,
                                           bool exclude_gt,
                                           int (&cnt)[ROWS_PER_WARP]) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp * ROWS_PER_WARP + rr;
        const float g = s.gt_score[r];
        const int gc = s.gt_col[r];
#pragma unroll
        for (int q = 0; q < BV / 32; ++q) {
            const int c = lane + 32 * q;
            const int col = col0 + c;
            const float x = s.c[r * LDC + c];
            const bool beats = (x > g && !(exclude_gt && col == gc)) ||
                               (x == g && col > gc);
            cnt[rr] += (col < v && beats) ? 1 : 0;
        }
    }
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__global__ void __launch_bounds__(THREADS)
sim_rank_wide_kernel(const __nv_bfloat16* __restrict__ txt,
                     const __nv_bfloat16* __restrict__ vis,
                     const int* __restrict__ gt, int t, int v, int hd,
                     int* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem& s = *reinterpret_cast<Smem*>(smem_raw);
    const int row0 = blockIdx.x * BT;
    for (int r = threadIdx.x; r < BT; r += THREADS) {
        s.gt_col[r] = (row0 + r < t) ? gt[row0 + r] : -1;
        s.gt_score[r] = 0.0f;
    }
    __syncthreads();
    const int n_tiles = (v + BV - 1) / BV;

    // sweep 1: ground-truth scores from the tiles that hold them
    for (int j = 0; j < n_tiles; ++j) {
        const int col0 = j * BV;
        int gc = -1;
        bool hit = false;
        if (threadIdx.x < BT) {
            gc = s.gt_col[threadIdx.x];
            hit = gc >= col0 && gc < col0 + BV;
        }
        if (!__syncthreads_or(hit)) continue;
        tile_scores(txt, vis, t, v, hd, row0, col0, s);
        if (hit) s.gt_score[threadIdx.x] = s.c[threadIdx.x * LDC + (gc - col0)];
        __syncthreads();
    }

    // sweep 2: count against those scores
    int cnt[ROWS_PER_WARP];
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) cnt[rr] = 0;
    for (int j = 0; j < n_tiles; ++j) {
        tile_scores(txt, vis, t, v, hd, row0, j * BV, s);
        count_tile(s, j * BV, v, false, cnt);
        __syncthreads();
    }
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int total = warp_sum(cnt[rr]);
        const int row = row0 + warp * ROWS_PER_WARP + rr;
        if ((threadIdx.x % 32) == 0 && row < t) out[row] = total + 1;
    }
}

__global__ void __launch_bounds__(THREADS)
sim_rank_tiled_kernel(const __nv_bfloat16* __restrict__ txt,
                      const __nv_bfloat16* __restrict__ vis,
                      const int* __restrict__ gt,
                      const float* __restrict__ gt_scores, int t, int v,
                      int hd, int tiles_per_split, int* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem& s = *reinterpret_cast<Smem*>(smem_raw);
    const int row0 = blockIdx.x * BT;
    for (int r = threadIdx.x; r < BT; r += THREADS) {
        const bool ok = row0 + r < t;
        s.gt_col[r] = ok ? gt[row0 + r] : -1;
        s.gt_score[r] = ok ? gt_scores[row0 + r] : 0.0f;
    }
    __syncthreads();
    const int n_tiles = (v + BV - 1) / BV;
    const int j0 = blockIdx.y * tiles_per_split;
    const int j1 = min(n_tiles, j0 + tiles_per_split);

    int cnt[ROWS_PER_WARP];
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) cnt[rr] = 0;
    for (int j = j0; j < j1; ++j) {
        tile_scores(txt, vis, t, v, hd, row0, j * BV, s);
        count_tile(s, j * BV, v, true, cnt);
        __syncthreads();
    }
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int total = warp_sum(cnt[rr]) + (blockIdx.y == 0 ? 1 : 0);
        const int row = row0 + warp * ROWS_PER_WARP + rr;
        if ((threadIdx.x % 32) == 0 && row < t) atomicAdd(out + row, total);
    }
}

}  // namespace

// C interface (bound with ctypes). Pointers are device pointers; txt is
// (t, hd) and vis (v, hd) row-major bf16 with hd % 64 == 0, gt (t,) int32,
// out (t,) int32. Returns the CUDA error code of the launch (0 = success).

extern "C" int laff_sim_rank_wide(const void* txt, const void* vis,
                                  const int* gt, int t, int v, int hd,
                                  int* out, void* stream) {
    const int smem = (int)sizeof(Smem);
    cudaFuncSetAttribute(sim_rank_wide_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dim3 grid((t + BT - 1) / BT);
    sim_rank_wide_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)txt, (const __nv_bfloat16*)vis, gt, t, v, hd, out);
    return (int)cudaGetLastError();
}

extern "C" int laff_sim_rank_tiled(const void* txt, const void* vis,
                                   const int* gt, const float* gt_scores,
                                   int t, int v, int hd, int* out,
                                   void* stream) {
    const int smem = (int)sizeof(Smem);
    cudaFuncSetAttribute(sim_rank_tiled_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int text_tiles = (t + BT - 1) / BT;
    const int n_tiles = (v + BV - 1) / BV;
    // enough blocks for two waves over 132 SMs when the text axis is short
    int splits = (264 + text_tiles - 1) / text_tiles;
    splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
    const int per_split = (n_tiles + splits - 1) / splits;
    splits = (n_tiles + per_split - 1) / per_split;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)t,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(text_tiles, splits);
    sim_rank_tiled_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)txt, (const __nv_bfloat16*)vis, gt, gt_scores,
        t, v, hd, per_split, out);
    return (int)cudaGetLastError();
}
