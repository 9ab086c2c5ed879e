// Fused LAFF multi-head gate (forward only) for Hopper.
//
// Replaces _gate_kernel / fused_gate_attention of
// laff_tpu/ops/pallas_kernels.py. For x (B, L, H, dh) f32, per (b, h):
//   mean    = sum_l x[l] / L
//   input_l = x[l] * mean  if mul  else  x[l]
//   logit_l = <input_l, k[h]> + bias[h];  w = softmax_l(logit)
//   out     = sum_l w_l x[l]  (+ g * L * mean  if with_ave)
//   y       = out / (|out| + 1e-14)
// which is MultiHeadGateAttention's forward for split heads with no mask,
// no pre-LN, no distinct fc and no fusion mix.
//
// Route: CUDA C++ rather than Triton, to keep one build route (nvcc + ctypes)
// for every kernel of the port; the work is a fused reduction pass that
// either route expresses.
//
// What bounds it: there is no matrix product, only about 8 operations per
// element read, so it is bound by bytes. At the eval batch of the LAFF-ml
// headline (B = 1024, L = 4, H = 8, dh = 512) it reads 67 MB and writes
// 17 MB: about 25 us at 3.35 TB/s. The design reads x exactly once: one
// block per (b, h) stages its L x dh slice in shared memory, so the mean,
// the logits, the weighted sum and the norm all run on the staged copy, and
// only the (dh,) result is written.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_L = 16;

__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    __syncthreads();  // scratch may still be read by a previous reduction
    if (lane == 0) scratch[warp] = x;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
    return total;
}

__global__ void __launch_bounds__(THREADS)
gate_kernel(const float* __restrict__ x, const float* __restrict__ kernel,
            const float* __restrict__ bias, float g, int l_count, int heads,
            int dh, int with_ave, int mul, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;                       // (L, dh)
    float* mean = xs + l_count * dh;        // (dh,)
    float* acc = mean + dh;                 // (dh,)
    float* scratch = acc + dh;              // (THREADS / 32,)

    const int bh = blockIdx.x;
    const int b = bh / heads;
    const int h = bh % heads;
    const float* k = kernel + (size_t)h * dh;

    for (int l = 0; l < l_count; ++l) {
        const float* src = x + (((size_t)b * l_count + l) * heads + h) * dh;
        for (int d = threadIdx.x; d < dh; d += THREADS) xs[l * dh + d] = src[d];
    }
    const float inv_l = 1.0f / (float)l_count;
    float part[MAX_L];
#pragma unroll
    for (int l = 0; l < MAX_L; ++l) part[l] = 0.0f;
    for (int d = threadIdx.x; d < dh; d += THREADS) {
        float m = 0.0f;
        for (int l = 0; l < l_count; ++l) m += xs[l * dh + d];
        m *= inv_l;
        mean[d] = m;
        const float kd = k[d];
#pragma unroll
        for (int l = 0; l < MAX_L; ++l) {
            if (l < l_count) {
                const float xv = xs[l * dh + d];
                part[l] += (mul ? xv * m : xv) * kd;
            }
        }
    }
    float logit[MAX_L];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int l = 0; l < MAX_L; ++l) {
        if (l < l_count) {
            logit[l] = block_sum(part[l], scratch) + bias[h];
            mx = fmaxf(mx, logit[l]);
        }
    }
    float denom = 0.0f;
#pragma unroll
    for (int l = 0; l < MAX_L; ++l) {
        if (l < l_count) {
            logit[l] = expf(logit[l] - mx);
            denom += logit[l];
        }
    }
    const float res_w = with_ave ? g * (float)l_count : 0.0f;
    float sq = 0.0f;
    for (int d = threadIdx.x; d < dh; d += THREADS) {
        float o = 0.0f;
#pragma unroll
        for (int l = 0; l < MAX_L; ++l)
            if (l < l_count) o += (logit[l] / denom) * xs[l * dh + d];
        o += res_w * mean[d];
        acc[d] = o;
        sq += o * o;
    }
    const float norm = sqrtf(block_sum(sq, scratch)) + 1e-14f;
    float* dst = out + ((size_t)b * heads + h) * dh;
    for (int d = threadIdx.x; d < dh; d += THREADS) dst[d] = acc[d] / norm;
}

}  // namespace

// C interface (bound with ctypes). x (b, l, heads, dh), kernel (heads, dh),
// bias (heads,), out (b, heads, dh): contiguous f32 device pointers, with
// l <= 16. Returns the CUDA error code of the launch (0 = success).
extern "C" int laff_gate_attention(const float* x, const float* kernel,
                                   const float* bias, float g, int b, int l,
                                   int heads, int dh, int with_ave, int mul,
                                   float* out, void* stream) {
    const int smem = (int)(sizeof(float) * ((size_t)(l + 2) * dh + THREADS / 32));
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    gate_kernel<<<b * heads, THREADS, smem, (cudaStream_t)stream>>>(
        x, kernel, bias, g, l, heads, dh, with_ave, mul, out);
    return (int)cudaGetLastError();
}
