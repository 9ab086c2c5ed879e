// Fused multi-head similarity + ground-truth rank counting for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of laff_tpu/ops/pallas_kernels.py:
//   wide branch  <- _sim_rank_kernel_wide (launched by fused_sim_rank, the
//                   single-gallery-block branch)
//   tiled branch <- _sim_rank_kernel (the tiled branch for galleries above
//                   the wide budget)
//
// Both compute, for every text row t, rank = 1 + #{cols scoring above the
// ground-truth column} + #{cols tying it at a larger index}, over columns
// below V, where a score is the bf16 x bf16 -> f32 product of a text row and
// a gallery row. The (T, V) score matrix never leaves the registers.
//
// What bounds it: at the MV-test3k shape (T = 59,800, V = 2,990, HD = 4,096)
// the product is 2 * T * V * HD = 1.46e12 operations, 1.48 ms at the card's
// 989 TFLOP/s bf16 peak, while the operands are 0.51 GB, 0.15 ms at
// 3.35 TB/s; the tiled shape (8,192 x 16,384 x 4,096) is 1.11 ms of
// operations. Both are bound by operations, which only wgmma reaches on
// Hopper. The design:
//
// * One main loop. A work item is one 128-row text tile times one BN-row
//   gallery tile. TMA copies 64-deep slices of both (K-major bf16, 128-byte
//   swizzle, zero fill past T and V) into a ring of STAGES shared-memory
//   stages, signalled by mbarriers. One producer thread issues the copies;
//   two consumer warpgroups (64 text rows each) issue wgmma m64 x BN x k16
//   with f32 accumulators in registers, keeping one group in flight.
//   setmaxnreg moves registers from the producer warpgroup (40 a thread) to
//   the consumers (232), which hold BN / 2 accumulators each. BN = 256 with
//   four 48 KB stages fills 193 KB of shared memory: one CTA per SM.
// * Counting on the accumulators. Each thread knows the (row, column) of
//   every accumulator it holds, compares them with its two rows' ground-truth
//   score and column held in registers, and keeps two row counts. At the end
//   of the item a quad shuffle sums them and one lane atomically adds them to
//   the row's rank; integer atomics are order-independent. No score goes to
//   shared or device memory.
// * A persistent grid of one CTA per SM (fewer when there are fewer items)
//   walks the items in groups of GROUP_TT text tiles, gallery-tile-major
//   inside a group, so the text tiles in flight and the gallery tiles they
//   meet stay in the 50 MB L2; there is no wave tail beyond the last item.
//   Every pass starts its gallery tiles on the BN grid.
//
// Where the ground-truth score comes from is the only difference:
// * Tiled: an f32 reduction of the f32 products apart from the count (as in
//   the JAX package; gt_dot, before the count); the ground-truth column is
//   excluded from the greater-count, so an exact match ranks 1.
// * Wide: the score must be bit-identical to the one the count compares
//   against, as the TPU kernel takes it from the tile it counts. A gt pass
//   runs the same main loop (same instruction, tile origins and k-order) over
//   only the (text tile, gallery tile) pairs that hold some row's
//   ground-truth column (a work list built on the card), and stores one
//   f32 per row; the count pass then compares against it without excluding
//   the column. With captions grouped by video the pass touches one or two
//   gallery tiles per text tile; with scattered ground truths, all of them.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;                   // text rows per work item
constexpr int BN = 256;                   // gallery rows per work item
constexpr int BK = 64;                    // depth of a stage: 128 bytes of bf16
constexpr int CONSUMERS = 2;              // consumer warpgroups, 64 text rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int GROUP_TT = 8;               // text tiles per scheduling group
constexpr int ACC = BN / 2;               // f32 accumulators per consumer thread
constexpr uint32_t A_BYTES = BM * BK * 2;
constexpr uint32_t B_BYTES = BN * BK * 2;
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment

static_assert(SMEM_BYTES <= 232448, "stages exceed the shared memory of an SM");

enum Mode { kTiled = 0, kWide = 1, kGt = 2 };

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c_inner, int c_outer) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
        : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows in
// TMA's 128-byte swizzle: 8-row groups 1,024 bytes apart (SBO), leading
// offset unused, layout type 1 (128B swizzle). The tile is 1,024-aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin the accumulators so the compiler neither reads them before the wgmma
// that writes them has been waited for nor moves them while it runs.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The it-th work item: (text tile, gallery tile). Count passes walk every
// pair in groups of GROUP_TT text tiles, gallery-tile-major inside a group;
// the gt pass walks its work list (ids tt * n_vt + vt, ascending, -1 after
// the last; see list_gt_tiles).
template <int MODE>
__device__ __forceinline__ bool work_item(int it, const int* __restrict__ items, int n_items,
                                          int n_tt, int n_vt, int& tt, int& vt) {
    if (it >= n_items) return false;
    if (MODE == kGt) {
        const int id = items[it];
        if (id < 0) return false;
        tt = id / n_vt;
        vt = id - tt * n_vt;
    } else {
        const int per_group = GROUP_TT * n_vt;
        const int g = it / per_group;
        const int first = g * GROUP_TT;
        const int rows = min(GROUP_TT, n_tt - first);
        const int local = it - g * per_group;
        tt = first + local % rows;
        vt = local / rows;
    }
    return true;
}

// Adds to c[h] the columns of the thread's row h that beat its ground truth
// (score g[h], column lg[h] in the thread's local numbering). Local column
// 8j + b of this thread is accumulator d[4j + 2h + b]; it lies inside the
// gallery when it is below lim (checked only when MASK).
template <int MODE, bool MASK>
__device__ __forceinline__ void count_tile(const float (&d)[ACC], const float (&g)[2],
                                           const int (&lg)[2], int lim, int (&c)[2]) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int col = 8 * j + b;
                const float x = d[4 * j + 2 * h + b];
                bool above = x > g[h];
                if (MODE == kTiled) above = above && col != lg[h];
                bool beats = above || (x == g[h] && col > lg[h]);
                if (MASK) beats = beats && col < lim;
                c[h] += beats ? 1 : 0;
            }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
sim_rank_kernel(const __grid_constant__ CUtensorMap txt_map,
                const __grid_constant__ CUtensorMap vis_map, const int* __restrict__ gt,
                float* __restrict__ gt_scores, const int* __restrict__ items, int t, int v,
                int hd, int* __restrict__ out) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t a_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t b_base = a_base + STAGES * A_BYTES;
    const uint32_t full = b_base + STAGES * B_BYTES;  // STAGES mbarriers: stage loaded
    const uint32_t empty = full + 8 * STAGES;         // STAGES mbarriers: stage consumed
    const int n_tt = (t + BM - 1) / BM;
    const int n_vt = (v + BN - 1) / BN;
    const int n_items = n_tt * n_vt;
    const int nk = hd / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == CONSUMERS) {
        // producer warpgroup: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (threadIdx.x == CONSUMERS * 128) {
            asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&txt_map))
                         : "memory");
            asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&vis_map))
                         : "memory");
            int stage = 0;
            uint32_t phase = 0;
            int tt, vt;
            for (int it = blockIdx.x; work_item<MODE>(it, items, n_items, n_tt, n_vt, tt, vt);
                 it += gridDim.x) {
                for (int kb = 0; kb < nk; ++kb) {
                    mbar_wait(empty + 8 * stage, phase ^ 1);
                    mbar_expect_tx(full + 8 * stage, STAGE_BYTES);
                    tma_load(a_base + stage * A_BYTES, &txt_map, full + 8 * stage, kb * BK, tt * BM);
                    tma_load(b_base + stage * B_BYTES, &vis_map, full + 8 * stage, kb * BK, vt * BN);
                    if (++stage == STAGES) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // consumer warpgroups: rows wg*64 .. wg*64+63 of each text tile
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
        const int lane = threadIdx.x % 32;
        const int q = lane % 4;
        const int r_local = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
        float d[ACC];
#pragma unroll
        for (int i = 0; i < ACC; ++i) d[i] = 0.0f;
        int stage = 0;
        uint32_t phase = 0;
        int tt, vt;
        for (int it = blockIdx.x; work_item<MODE>(it, items, n_items, n_tt, n_vt, tt, vt);
             it += gridDim.x) {
            const int col0 = vt * BN;
            int row[2], lg[2];
            float g[2];
            bool ok[2];  // a row below t whose ground truth lies in [0, v)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                row[h] = tt * BM + r_local + 8 * h;
                const int col = row[h] < t ? gt[row[h]] : -1;
                ok[h] = col >= 0 && col < v;
                lg[h] = (ok[h] ? col : -1) - col0 - 2 * q;
                g[h] = (ok[h] && MODE != kGt) ? gt_scores[row[h]] : 0.0f;
            }

            fence_acc(d);
            int prev = 0;
            for (int kb = 0; kb < nk; ++kb) {
                mbar_wait(full + 8 * stage, phase);
                const uint64_t da = smem_desc(a_base + stage * A_BYTES + wg * 64 * 128);
                const uint64_t db = smem_desc(b_base + stage * B_BYTES);
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < BK / 16; ++k)  // 32 bytes deeper per step
                    wgmma_m64n256(d, da + 2 * k, db + 2 * k, (kb > 0 || k > 0) ? 1 : 0);
                wgmma_commit();
                wgmma_wait<1>();  // the previous stage's products are done
                if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
                prev = stage;
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            fence_acc(d);
            if (lane == 0) mbar_arrive(empty + 8 * prev);

            if (MODE == kGt) {
                // the thread holding a row's ground-truth column stores its score
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float s = 0.0f;
                    bool hit = false;
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                        for (int b = 0; b < 2; ++b)
                            if (8 * j + b == lg[h]) {
                                s = d[4 * j + 2 * h + b];
                                hit = true;
                            }
                    if (hit && ok[h]) gt_scores[row[h]] = s;
                }
            } else {
                int c[2] = {0, 0};
                if (col0 + BN <= v)
                    count_tile<MODE, false>(d, g, lg, 0, c);
                else
                    count_tile<MODE, true>(d, g, lg, v - col0 - 2 * q, c);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    c[h] += __shfl_xor_sync(0xffffffffu, c[h], 1);
                    c[h] += __shfl_xor_sync(0xffffffffu, c[h], 2);
                    if (q == 0 && ok[h]) atomicAdd(out + row[h], c[h] + (vt == 0 ? 1 : 0));
                }
            }
        }
    }
}

// Ground-truth scores of the tiled branch, an f32 reduction apart from the
// count as in the JAX package: for each row, the f32 sum of the f32 products
// of its bf16 text row and its ground truth's gallery row. One warp per row,
// 8 products per lane per 16-byte load. A row whose ground truth lies
// outside [0, v) is skipped (the count pass gives it no rank).
constexpr int DOT_WARPS = 8;

__global__ void __launch_bounds__(DOT_WARPS * 32)
gt_dot(const __nv_bfloat16* __restrict__ txt, const __nv_bfloat16* __restrict__ vis,
       const int* __restrict__ gt, int t, int v, int hd, float* __restrict__ gt_scores) {
    const int row = blockIdx.x * DOT_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= t) return;
    const int col = gt[row];
    if (col < 0 || col >= v) return;
    const uint4* a = reinterpret_cast<const uint4*>(txt + (size_t)row * hd);
    const uint4* b = reinterpret_cast<const uint4*>(vis + (size_t)col * hd);
    float sum = 0.0f;
    for (int i = lane; i < hd / 8; i += 32) {
        const uint4 x = a[i];
        const uint4 y = b[i];
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float2 xf = __bfloat1622float2(xp[k]);
            const float2 yf = __bfloat1622float2(yp[k]);
            sum += xf.x * yf.x;
            sum += xf.y * yf.y;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) gt_scores[row] = sum;
}

// The wide gt pass's work list, built on the card: mark_gt_tiles flags each
// (text tile, gallery tile) item that holds some row's ground-truth column;
// list_gt_tiles, one block, writes the flagged ids in ascending order and
// -1 after the last. A ground truth outside [0, v) flags nothing.
__global__ void mark_gt_tiles(const int* __restrict__ gt, int t, int v, int n_vt,
                              int* __restrict__ flags) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= t) return;
    const int col = gt[row];
    if (col >= 0 && col < v) flags[(row / BM) * n_vt + col / BN] = 1;
}

constexpr int LIST_THREADS = 1024;

__global__ void __launch_bounds__(LIST_THREADS)
list_gt_tiles(const int* __restrict__ flags, int n, int* __restrict__ items) {
    __shared__ int warp_count[LIST_THREADS / 32];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    int base = 0;  // ids listed so far
    for (int start = 0; start < n; start += LIST_THREADS) {
        const int i = start + threadIdx.x;
        const bool held = i < n && flags[i] != 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, held);
        if (lane == 0) warp_count[warp] = __popc(ballot);
        __syncthreads();
        int before = base;
        int total = base;
        for (int w = 0; w < LIST_THREADS / 32; ++w) {
            total += warp_count[w];
            if (w < warp) before += warp_count[w];
        }
        if (held) items[before + __popc(ballot & ((1u << lane) - 1))] = i;
        base = total;
        __syncthreads();
    }
    for (int i = base + threadIdx.x; i < n; i += LIST_THREADS) items[i] = -1;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of the C interface besides CUDA's own (which are positive).
constexpr int kNoEncoder = -1;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kBadTensorMap = -2;

EncodeTiledFn encoder() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
        if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// (rows, hd) row-major bf16 read in boxes of box_rows x 64, 128-byte swizzle,
// zeros past the last row.
int make_map(CUtensorMap* map, const void* ptr, int rows, int hd, int box_rows) {
    EncodeTiledFn fn = encoder();
    if (fn == nullptr) return kNoEncoder;
    const cuuint64_t dims[2] = {(cuuint64_t)hd, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)hd * 2};
    const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <int MODE>
int launch(const CUtensorMap& txt_map, const CUtensorMap& vis_map, const int* gt,
           float* gt_scores, const int* items, int t, int v, int hd, int* out,
           cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(sim_rank_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long n_items = (long long)((t + BM - 1) / BM) * ((v + BN - 1) / BN);
    const int grid = (int)(n_items < sms ? n_items : sms);
    sim_rank_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(txt_map, vis_map, gt, gt_scores,
                                                                   items, t, v, hd, out);
    return (int)cudaGetLastError();
}

int make_maps(CUtensorMap* txt_map, CUtensorMap* vis_map, const void* txt, const void* vis,
              int t, int v, int hd) {
    int err = make_map(txt_map, txt, t, hd, BM);
    return err != 0 ? err : make_map(vis_map, vis, v, hd, BN);
}

}  // namespace

// C interface (bound with ctypes). Pointers are device pointers, 16-byte
// aligned; txt is (t, hd) and vis (v, hd) row-major bf16 with hd % 64 == 0,
// gt (t,) int32, out (t,) int32. A row whose ground truth lies outside
// [0, v) gets rank 0, which no valid row has. Returns 0 on success, a CUDA
// error code, or one of the negative codes above.

// work: (2 * n_items,) int32 scratch, n_items = ceil(t / BM) * ceil(v / BN),
// for the gt pass's flags and work list; gt_scores: (t,) f32 scratch the gt
// pass fills and the count pass reads.
extern "C" int laff_sim_rank_wide(const void* txt, const void* vis, const int* gt, int* work,
                                  float* gt_scores, int t, int v, int hd, int* out,
                                  void* stream) {
    CUtensorMap txt_map, vis_map;
    int err = make_maps(&txt_map, &vis_map, txt, vis, t, v, hd);
    if (err != 0) return err;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_vt = (v + BN - 1) / BN;
    const int n_items = ((t + BM - 1) / BM) * n_vt;
    int* flags = work;
    int* items = work + n_items;
    err = (int)cudaMemsetAsync(out, 0, sizeof(int) * (size_t)t, s);
    if (err == 0) err = (int)cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)n_items, s);
    if (err != 0) return err;
    mark_gt_tiles<<<(t + 255) / 256, 256, 0, s>>>(gt, t, v, n_vt, flags);
    list_gt_tiles<<<1, LIST_THREADS, 0, s>>>(flags, n_items, items);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    err = launch<kGt>(txt_map, vis_map, gt, gt_scores, items, t, v, hd, out, s);
    if (err != 0) return err;
    return launch<kWide>(txt_map, vis_map, gt, gt_scores, nullptr, t, v, hd, out, s);
}

// gt_scores: (t,) f32 scratch for the ground-truth scores.
extern "C" int laff_sim_rank_tiled(const void* txt, const void* vis, const int* gt,
                                   float* gt_scores, int t, int v, int hd, int* out,
                                   void* stream) {
    CUtensorMap txt_map, vis_map;
    int err = make_maps(&txt_map, &vis_map, txt, vis, t, v, hd);
    if (err != 0) return err;
    cudaStream_t s = (cudaStream_t)stream;
    err = (int)cudaMemsetAsync(out, 0, sizeof(int) * (size_t)t, s);
    if (err != 0) return err;
    gt_dot<<<(t + DOT_WARPS - 1) / DOT_WARPS, DOT_WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)txt, (const __nv_bfloat16*)vis, gt, t, v, hd, gt_scores);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch<kTiled>(txt_map, vis_map, gt, gt_scores, nullptr, t, v, hd, out, s);
}
