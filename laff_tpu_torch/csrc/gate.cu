// Fused LAFF multi-head gate (forward only) for Hopper (sm_90a).
//
// Replaces _gate_kernel / fused_gate_attention of
// laff_tpu/ops/pallas_kernels.py. For x (B, L, H, dh) f32, per (b, h):
//   mean    = sum_l x[l] / L
//   input_l = x[l] * mean  if mul  else  x[l]
//   logit_l = <input_l, k[h]> + bias[h];  w = softmax_l(logit)
//   out     = sum_l w_l x[l]  (+ g * mean * L  if with_ave)
//   y       = out / (|out| + 1e-14)
// which is MultiHeadGateAttention's forward for split heads with no mask,
// no pre-LN, no distinct fc and no fusion mix. g is read from device memory,
// so a caller's device scalar never has to come to the host.
//
// What bounds it: about 2 operations per byte read (a mean, L dot products,
// a weighted sum and a norm per element), far below the card's ridge point,
// so the gate is bound by bytes and has no use for tensor cores. At the eval
// batch of the LAFF-ml headline (B 1,024, L 4, H 8, dh 512) it reads 67 MB
// and writes 17 MB: 25 us at 3.35 TB/s; at FrameLAFF's video tower (L 5) it
// reads 84 MB: 30 us. x is read from device memory once.
//
// The ring kernel (gate_ring_kernel) keeps that read in flight:
// * A persistent grid (as many CTAs as fit on the SMs, at most one per unit)
//   walks work units. One producer thread fills a ring of shared-memory
//   stages with 1-D bulk asynchronous copies (cp.async.bulk ... complete_tx;
//   no tensor map), signalled by full/empty mbarriers (mbarrier.cuh).
// * How a unit is cut depends on the bytes of one batch row (L x H x dh
//   floats), in three layouts (ring_geometry; *route reports which):
//   - packed rows, rows of at most STAGE_BYTES (72 KB; the headline's L 4
//     row is 64 KB): 3 stages, each one row or, when rows are small and the
//     batch leaves each CTA enough units, several consecutive rows, with all
//     their heads. 192 KB per SM in flight at the headline.
//   - whole rows, rows up to half of RING_BYTES (224 KB: L 5 to 7 at H 8,
//     dh 512, FrameLAFF's video tower at L 5): 2 stages sized to one row
//     each (80 KB at L 5), the row arriving in one contiguous copy, so each
//     of the 8 consumer warps takes one head of H 8 and none idles. At
//     3.35 TB/s and ~1 us Little's law asks for ~25 KB per SM in flight; one
//     row loads while the other is read.
//   - head split, larger rows (L 8 at H 8, dh 512; no configuration of the
//     repo runs one): as in the packed rows' ring, 3 stages of 72 KB, a unit
//     one row's next STAGE_BYTES / (L x dh x 4) heads, one copy a position.
//   Whole rows were chosen over even head groups (two groups of consumer
//   warps, each on half-rows of stages of its own): they need one copy a
//   row instead of L, and one walk of the stages shared by all consumer
//   warps, as in the packed rows' ring, with no split of the warps into
//   groups. At (B 1,024, L 5, H 8, dh 512) they read at 72 % of the bound
//   (0.042 ms on an H100 80GB HBM3 at 700 W).
// * Each consumer warp takes one (row, head) of a unit at a time. Its lanes
//   read float4s of the head's L slices from the stage (conflict-free) and
//   form the mean, the L logits, the softmax, the weighted sum and the norm
//   in registers, reducing with __shfl_xor_sync only: no __syncthreads and
//   no shared scratch. Where L <= 8 and dh <= 512 (both LAFF-ml's L 4 and
//   FrameLAFF's L 5 at dh 512: up to 32 float4s a lane) or L <= 16 and
//   dh <= 128, each lane reads the stage once and keeps its part of the
//   head in registers (gate_head_regs, one order of operations for every
//   instantiation); otherwise (dh above 512, or L above 8 with dh above 128)
//   it reads the stage three times, for the logits, the norm and the output,
//   recomputing what each pass needs (gate_head). The stage is never
//   written. Results leave as 128-bit streaming stores.
// * The consumers' arithmetic is on the critical path: with eight warps per
//   SM, a row's 64 KB arrives about every 2.6 us at the card's rate, and a
//   warp has that long for its head. Templates on the position bound and the
//   options keep branches and dead sums out of the inner loops.
// Shapes outside the ring's conditions (dh % 4 != 0, x, the gate kernel or
// out not 16-byte aligned, or one head's L slices above STAGE_BYTES) take
// gate_simple_kernel: one warp per (row, head), scalar loads straight from
// device memory, the same passes and the same arithmetic.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int MAX_L = 16;                               // positions; the wrapper checks L
constexpr int CONSUMER_WARPS = 8;
constexpr int RING_THREADS = (CONSUMER_WARPS + 1) * 32;  // + one producer warp
constexpr int STAGES = 3;                               // stages of packed rows or a head split
constexpr int STAGE_BYTES = 72 * 1024;  // a stage of packed rows or of a head split at most
constexpr int RING_BYTES = 224 * 1024;  // all stages of a ring together at most
constexpr int UNITS_PER_CTA = 4;        // small rows pack down to this
constexpr int SIMPLE_WARPS = 8;

// *route of laff_gate_attention: the ring kernel in one of its layouts, or
// the simple kernel
enum Route { ROUTE_PACKED_ROWS = 0, ROUTE_SIMPLE = 1, ROUTE_WHOLE_ROWS = 2, ROUTE_HEAD_SPLIT = 3 };

static_assert(STAGES * STAGE_BYTES <= RING_BYTES, "packed rows exceed the ring");
static_assert(RING_BYTES + 16 * STAGES <= 232448, "the ring exceeds the shared memory of an SM");

// How the ring kernel cuts the batch into units.
struct Geometry {
    int b, l, heads, dh;
    int rows;          // batch rows per unit (more than one only with all heads)
    int unit_heads;    // heads per unit
    int head_groups;   // units per group of rows: ceil(heads / unit_heads)
    int units;
    int stage_floats;  // rows * l * unit_heads * dh
    int stages;        // 2 (whole rows) or STAGES
    int route;         // the layout, a Route
};

template <int N>
struct Vec {
    float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> load_vec(const float* p) {
    Vec<N> r;
    if constexpr (N == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        r.v[0] = t.x;
        r.v[1] = t.y;
        r.v[2] = t.z;
        r.v[3] = t.w;
    } else {
        r.v[0] = *p;
    }
    return r;
}

template <int N>
__device__ __forceinline__ Vec<N> load_ro(const float* __restrict__ p) {
    Vec<N> r;
    if constexpr (N == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        r.v[0] = t.x;
        r.v[1] = t.y;
        r.v[2] = t.z;
        r.v[3] = t.w;
    } else {
        r.v[0] = __ldg(p);
    }
    return r;
}

template <int N>
__device__ __forceinline__ void store_streaming(float* p, const Vec<N>& x) {
    if constexpr (N == 4)
        __stcs(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
    else
        __stcs(p, x.v[0]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// The mean over the L positions of N elements; xs points at position 0,
// position l lies l * ls floats further. LMAX bounds L at compile time.
template <int N, int LMAX>
__device__ __forceinline__ Vec<N> mean_of(const float* xs, int ls, int L, float inv_l) {
    Vec<N> s;
#pragma unroll
    for (int i = 0; i < N; ++i) s.v[i] = 0.0f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
        if (l < L) {
            const Vec<N> v = load_vec<N>(xs + l * ls);
#pragma unroll
            for (int i = 0; i < N; ++i) s.v[i] += v.v[i];
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) s.v[i] *= inv_l;
    return s;
}

// sum_l w_l x[l] (+ g * mean * L  if AVE) for N elements.
template <int N, int LMAX, bool AVE>
__device__ __forceinline__ Vec<N> combine(const float* xs, int ls, int L, const float (&w)[LMAX],
                                          float g, float inv_l) {
    Vec<N> o, s;
#pragma unroll
    for (int i = 0; i < N; ++i) o.v[i] = s.v[i] = 0.0f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
        if (l < L) {
            const Vec<N> v = load_vec<N>(xs + l * ls);
#pragma unroll
            for (int i = 0; i < N; ++i) {
                o.v[i] = fmaf(w[l], v.v[i], o.v[i]);
                if (AVE) s.v[i] += v.v[i];
            }
        }
    }
    if (AVE) {
#pragma unroll
        for (int i = 0; i < N; ++i) o.v[i] += g * (s.v[i] * inv_l) * (float)L;
    }
    return o;
}

// The partial logits w[0..L) of a warp's lanes become softmax weights:
// summed over the warp, biased, exponentiated from their max, normalised.
template <int LMAX>
__device__ __forceinline__ void softmax_weights(float (&w)[LMAX], int L, float bias_h) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
        if (l < L) {
            w[l] = warp_sum(w[l]) + bias_h;
            mx = fmaxf(mx, w[l]);
        }
    }
    float denom = 0.0f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
        if (l < L) {
            w[l] = expf(w[l] - mx);
            denom += w[l];
        }
    }
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
        if (l < L) w[l] = w[l] / denom;
}

// One (row, head), computed by one warp: xs points at the head's slice of
// position 0 (position l lies l * ls floats further), k at the head's gate
// kernel, dst at its output. Lane j takes elements N*j + 32*N*i .. +N-1.
// L <= LMAX. Three passes over xs (logits, norm, output), each recomputing
// what it needs; the chunk loops are unrolled so that each lane has the
// loads of several chunks in flight at once.
template <int N, int LMAX, bool MUL, bool AVE>
__device__ __forceinline__ void gate_head(const float* xs, int ls, int L, int dh,
                                          const float* __restrict__ k, float bias_h, float g,
                                          float* __restrict__ dst, int lane) {
    const float inv_l = 1.0f / (float)L;
    float w[LMAX];  // partial logits, then softmax weights
#pragma unroll
    for (int l = 0; l < LMAX; ++l) w[l] = 0.0f;
#pragma unroll 4
    for (int d = N * lane; d < dh; d += 32 * N) {
        const Vec<N> kv = load_ro<N>(k + d);
        Vec<N> m;
        if (MUL) m = mean_of<N, LMAX>(xs + d, ls, L, inv_l);
#pragma unroll
        for (int l = 0; l < LMAX; ++l) {
            if (l < L) {
                const Vec<N> v = load_vec<N>(xs + l * ls + d);
#pragma unroll
                for (int i = 0; i < N; ++i)
                    w[l] = fmaf(MUL ? v.v[i] * m.v[i] : v.v[i], kv.v[i], w[l]);
            }
        }
    }
    softmax_weights<LMAX>(w, L, bias_h);

    float sq = 0.0f;
#pragma unroll 4
    for (int d = N * lane; d < dh; d += 32 * N) {
        const Vec<N> o = combine<N, LMAX, AVE>(xs + d, ls, L, w, g, inv_l);
#pragma unroll
        for (int i = 0; i < N; ++i) sq = fmaf(o.v[i], o.v[i], sq);
    }
    const float inv_norm = 1.0f / (sqrtf(warp_sum(sq)) + 1e-14f);
#pragma unroll 4
    for (int d = N * lane; d < dh; d += 32 * N) {
        Vec<N> o = combine<N, LMAX, AVE>(xs + d, ls, L, w, g, inv_l);
#pragma unroll
        for (int i = 0; i < N; ++i) o.v[i] *= inv_norm;
        store_streaming<N>(dst + d, o);
    }
}

// The mean over the L positions of chunk c of a lane's registers.
template <int LMAX, int CPL>
__device__ __forceinline__ Vec<4> regs_mean(const Vec<4> (&xv)[LMAX][CPL], int c, int L,
                                            float inv_l) {
    Vec<4> m;
#pragma unroll
    for (int i = 0; i < 4; ++i) m.v[i] = 0.0f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
        if (l < L)
#pragma unroll
            for (int i = 0; i < 4; ++i) m.v[i] += xv[l][c].v[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) m.v[i] *= inv_l;
    return m;
}

// gate_head for a head that fits the lanes' registers: L <= LMAX and
// dh <= 128 * CPL. Each lane loads its CPL float4 chunks of every position
// from the stage once, and every step runs on those registers, in the same
// order of operations as gate_head. The mean is formed where it is used (the
// logits with MUL, the residual with AVE), the same sum each time, so that
// no more than the head and one chunk's sums are live at once: with 9 warps
// a CTA, a thread has 168 registers, and LMAX 8 x CPL 4 holds 128 floats.
template <int LMAX, int CPL, bool MUL, bool AVE>
__device__ __forceinline__ void gate_head_regs(const float* xs, int ls, int L, int dh,
                                               const float* __restrict__ k, float bias_h, float g,
                                               float* __restrict__ dst, int lane) {
    const float inv_l = 1.0f / (float)L;
    Vec<4> xv[LMAX][CPL];
    float w[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) w[l] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        const int d = 4 * lane + 128 * c;
#pragma unroll
        for (int l = 0; l < LMAX; ++l) {
            if (l < L && d < dh) {
                xv[l][c] = load_vec<4>(xs + l * ls + d);
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) xv[l][c].v[i] = 0.0f;
            }
        }
        if (d < dh) {
            const Vec<4> kv = load_ro<4>(k + d);
            Vec<4> m;
            if (MUL) m = regs_mean<LMAX, CPL>(xv, c, L, inv_l);
#pragma unroll
            for (int l = 0; l < LMAX; ++l)
                if (l < L)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        w[l] = fmaf(MUL ? xv[l][c].v[i] * m.v[i] : xv[l][c].v[i], kv.v[i], w[l]);
        }
    }
    softmax_weights<LMAX>(w, L, bias_h);

    Vec<4> o[CPL];
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[c].v[i] = 0.0f;
#pragma unroll
        for (int l = 0; l < LMAX; ++l)
            if (l < L)
#pragma unroll
                for (int i = 0; i < 4; ++i) o[c].v[i] = fmaf(w[l], xv[l][c].v[i], o[c].v[i]);
        if (AVE) {
            const Vec<4> m = regs_mean<LMAX, CPL>(xv, c, L, inv_l);
#pragma unroll
            for (int i = 0; i < 4; ++i) o[c].v[i] += g * m.v[i] * (float)L;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sq = fmaf(o[c].v[i], o[c].v[i], sq);
    }
    const float inv_norm = 1.0f / (sqrtf(warp_sum(sq)) + 1e-14f);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        const int d = 4 * lane + 128 * c;
        if (d < dh) {
#pragma unroll
            for (int i = 0; i < 4; ++i) o[c].v[i] *= inv_norm;
            store_streaming<4>(dst + d, o[c]);
        }
    }
}

// Unit u: rows b0 .. b0 + rows - 1, heads h0 .. h0 + hn - 1.
__device__ __forceinline__ void unit_span(const Geometry& geo, int u, int& b0, int& rows, int& h0,
                                          int& hn) {
    const int rg = u / geo.head_groups;
    b0 = rg * geo.rows;
    rows = min(geo.rows, geo.b - b0);
    h0 = (u - rg * geo.head_groups) * geo.unit_heads;
    hn = min(geo.unit_heads, geo.heads - h0);
}

// CPL > 0: heads held in registers (gate_head_regs<LMAX, CPL>); CPL == 0:
// heads read from the stage in passes (gate_head).
template <int LMAX, int CPL, bool MUL, bool AVE>
__global__ void __launch_bounds__(RING_THREADS, 1)
gate_ring_kernel(const float* __restrict__ x, const float* __restrict__ kernel,
                 const float* __restrict__ bias, const float* __restrict__ g_ptr,
                 const Geometry geo, float* __restrict__ out) {
    // geo.stages stages of stage_floats, then the barriers. A stage holds a
    // unit as (rows, l, hn, dh): whole rows as they lie in x, or one row's
    // head split, one copy per position.
    extern __shared__ __align__(16) float ring[];
    const uint32_t stage_bytes = (uint32_t)geo.stage_floats * 4u;
    const uint32_t full = smem_u32(ring) + geo.stages * stage_bytes;  // stage loaded
    const uint32_t empty = full + 8 * geo.stages;                      // stage consumed
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            if (s < geo.stages) {
                mbar_init(full + 8 * s, 1);
                mbar_init(empty + 8 * s, CONSUMER_WARPS);  // one arrival per consumer warp
            }
        }
        mbar_init_fence();
    }
    __syncthreads();

    // The CTA's r-th unit uses stage r % geo.stages in phase (r / geo.stages)
    // & 1, both counted rather than divided.
    int b0, rows, h0, hn;
    if (warp == CONSUMER_WARPS) {
        // producer: one thread keeps the ring full
        if (lane == 0) {
            int stage = 0;
            uint32_t phase = 0;
            for (int u = blockIdx.x; u < geo.units; u += gridDim.x) {
                mbar_wait(empty + 8 * stage, phase ^ 1);
                unit_span(geo, u, b0, rows, h0, hn);
                const uint32_t bar = full + 8 * stage;
                const uint32_t dst = smem_u32(ring) + stage * stage_bytes;
                const uint32_t slice = (uint32_t)hn * geo.dh * 4u;  // one position's heads
                const float* src = x + ((size_t)b0 * geo.l * geo.heads + h0) * geo.dh;
                if (hn == geo.heads) {  // whole rows: one contiguous copy
                    const uint32_t bytes = (uint32_t)rows * geo.l * slice;
                    mbar_expect_tx(bar, bytes);
                    bulk_load(dst, src, bytes, bar);
                } else {
                    mbar_expect_tx(bar, (uint32_t)geo.l * slice);
                    for (int l = 0; l < geo.l; ++l)
                        bulk_load(dst + l * slice, src + (size_t)l * geo.heads * geo.dh, slice, bar);
                }
                if (++stage == geo.stages) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // consumers: one warp per (row, head) of the unit
    const float g = AVE ? __ldg(g_ptr) : 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < geo.units; u += gridDim.x) {
        mbar_wait(full + 8 * stage, phase);
        unit_span(geo, u, b0, rows, h0, hn);
        const float* tile = ring + (size_t)stage * geo.stage_floats;
        for (int task = warp; task < rows * hn; task += CONSUMER_WARPS) {
            const int ri = task / hn;
            const int hi = task - ri * hn;
            const int h = h0 + hi;
            const float* xs = tile + ((size_t)ri * geo.l * hn + hi) * geo.dh;
            float* dst = out + ((size_t)(b0 + ri) * geo.heads + h) * geo.dh;
            if constexpr (CPL > 0)
                gate_head_regs<LMAX, CPL, MUL, AVE>(xs, hn * geo.dh, geo.l, geo.dh,
                                                    kernel + (size_t)h * geo.dh, __ldg(bias + h),
                                                    g, dst, lane);
            else
                gate_head<4, LMAX, MUL, AVE>(xs, hn * geo.dh, geo.l, geo.dh,
                                             kernel + (size_t)h * geo.dh, __ldg(bias + h), g, dst,
                                             lane);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == geo.stages) {
            stage = 0;
            phase ^= 1;
        }
    }
}

template <bool MUL, bool AVE>
__global__ void __launch_bounds__(SIMPLE_WARPS * 32)
gate_simple_kernel(const float* __restrict__ x, const float* __restrict__ kernel,
                   const float* __restrict__ bias, const float* __restrict__ g_ptr, int b, int l,
                   int heads, int dh, float* __restrict__ out) {
    const int lane = threadIdx.x % 32;
    const float g = AVE ? __ldg(g_ptr) : 0.0f;
    const long long tasks = (long long)b * heads;
    for (long long task = (long long)blockIdx.x * SIMPLE_WARPS + threadIdx.x / 32; task < tasks;
         task += (long long)gridDim.x * SIMPLE_WARPS) {
        const long long row = task / heads;
        const int h = (int)(task - row * heads);
        gate_head<1, MAX_L, MUL, AVE>(x + ((size_t)row * l * heads + h) * dh, heads * dh, l, dh,
                                      kernel + (size_t)h * dh, __ldg(bias + h), g,
                                      out + (size_t)task * dh, lane);
    }
}

Geometry ring_geometry(int b, int l, int heads, int dh, int sms) {
    Geometry geo;
    geo.b = b;
    geo.l = l;
    geo.heads = heads;
    geo.dh = dh;
    geo.rows = 1;
    geo.unit_heads = heads;
    geo.stages = STAGES;
    const long long head_bytes = (long long)l * dh * 4;
    const long long row_bytes = head_bytes * heads;
    if (row_bytes <= STAGE_BYTES) {  // packed rows
        const long long fit = STAGE_BYTES / row_bytes;
        const long long per_unit = (long long)sms * UNITS_PER_CTA;
        const long long want = (b + per_unit - 1) / per_unit;
        geo.rows = (int)(want < fit ? want : fit);
        geo.route = ROUTE_PACKED_ROWS;
    } else if (2 * row_bytes <= RING_BYTES) {  // whole rows, two stages of one row
        geo.stages = 2;
        geo.route = ROUTE_WHOLE_ROWS;
    } else {  // head split; the wrapper keeps head_bytes <= STAGE_BYTES
        geo.unit_heads = (int)(STAGE_BYTES / head_bytes);
        geo.route = ROUTE_HEAD_SPLIT;
    }
    geo.head_groups = (heads + geo.unit_heads - 1) / geo.unit_heads;
    geo.units = ((b + geo.rows - 1) / geo.rows) * geo.head_groups;
    geo.stage_floats = geo.rows * l * geo.unit_heads * dh;
    return geo;
}

typedef void (*RingKernel)(const float*, const float*, const float*, const float*, Geometry,
                           float*);
typedef void (*SimpleKernel)(const float*, const float*, const float*, const float*, int, int, int,
                             int, float*);

template <int LMAX, int CPL>
RingKernel ring_kernel(int mul, int ave) {
    if (mul)
        return ave ? gate_ring_kernel<LMAX, CPL, true, true> : gate_ring_kernel<LMAX, CPL, true, false>;
    return ave ? gate_ring_kernel<LMAX, CPL, false, true> : gate_ring_kernel<LMAX, CPL, false, false>;
}

// Heads in registers where 16 float4s a lane hold them (L 4 x dh 512, L 8 x
// dh 256, L 16 x dh 128) or 32 do (L 8 x dh 512: 128 floats a lane, within
// the 168 registers a thread that ptxas allows a CTA of nine warps), else
// read from the stage in passes.
RingKernel pick_ring_kernel(int l, int dh, int mul, int ave) {
    if (l <= 4 && dh <= 512) return ring_kernel<4, 4>(mul, ave);
    if (l <= 8 && dh <= 256) return ring_kernel<8, 2>(mul, ave);
    if (l <= 8 && dh <= 512) return ring_kernel<8, 4>(mul, ave);
    if (dh <= 128) return ring_kernel<MAX_L, 1>(mul, ave);
    return ring_kernel<MAX_L, 0>(mul, ave);
}

SimpleKernel pick_simple_kernel(int mul, int ave) {
    if (mul) return ave ? gate_simple_kernel<true, true> : gate_simple_kernel<true, false>;
    return ave ? gate_simple_kernel<false, true> : gate_simple_kernel<false, false>;
}

}  // namespace

// C interface (bound with ctypes). x (b, l, heads, dh), kernel (heads, dh),
// bias (heads,), out (b, heads, dh): contiguous f32 device pointers, with
// 1 <= l <= 16; g: one f32 on the device, read only when with_ave (may be
// null otherwise). *route receives the kernel launched: 1 the simple kernel;
// 0, 2 or 3 the ring kernel with packed rows, whole rows or a head split (a
// Route). Returns the CUDA error code of the launch (0 = success).
extern "C" int laff_gate_attention(const float* x, const float* kernel, const float* bias,
                                   const float* g, int b, int l, int heads, int dh, int with_ave,
                                   int mul, float* out, int* route, void* stream) {
    if (b < 1 || l < 1 || l > MAX_L || heads < 1 || dh < 1 || (with_ave && g == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const uintptr_t addresses = reinterpret_cast<uintptr_t>(x) |
                                reinterpret_cast<uintptr_t>(kernel) |
                                reinterpret_cast<uintptr_t>(out);
    if (dh % 4 == 0 && addresses % 16 == 0 && (long long)l * dh * 4 <= STAGE_BYTES) {
        const Geometry geo = ring_geometry(b, l, heads, dh, sms);
        const int smem = geo.stages * (geo.stage_floats * 4 + 16);  // stages and barriers
        const RingKernel fn = pick_ring_kernel(l, dh, mul, with_ave);
        // the last launch's settings, so a loop of equal calls asks once
        static RingKernel last_fn = nullptr;
        static int last_device = -1, last_smem = -1, per_sm = 0;
        if (fn != last_fn || device != last_device || smem != last_smem) {
            err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err == cudaSuccess)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, RING_THREADS, smem);
            if (err != cudaSuccess) {
                last_fn = nullptr;
                return (int)err;
            }
            last_fn = fn;
            last_device = device;
            last_smem = smem;
        }
        const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
        const int grid = (int)(geo.units < slots ? geo.units : slots);
        fn<<<grid, RING_THREADS, smem, s>>>(x, kernel, bias, g, geo, out);
        *route = geo.route;
    } else {
        const SimpleKernel fn = pick_simple_kernel(mul, with_ave);
        const long long blocks = ((long long)b * heads + SIMPLE_WARPS - 1) / SIMPLE_WARPS;
        const long long most = (long long)sms * 16;
        fn<<<(int)(blocks < most ? blocks : most), SIMPLE_WARPS * 32, 0, s>>>(
            x, kernel, bias, g, b, l, heads, dh, out);
        *route = ROUTE_SIMPLE;
    }
    return (int)cudaGetLastError();
}
