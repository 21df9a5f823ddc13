// Kernel K3: the fused vision epilogue (K3' is the same kernel at T = 1).
//
// Replaces: vaudio/ops/vision_kernel.py, _vision_stats_batched_call (body
// _vision_kernel_batched) and, at T = 1, _vision_stats_call (body
// _vision_kernel) — the TPU kernels that run everything after the mip pool
// in one VMEM pass: HSI, the gated hue histogram, the four intensity
// stencils and the per-cell gradient statistics.
//
// What it computes, per frame of f32 mip planes (3, hm, wm):
//   * HSI with the TPU kernel's own fdlibm acosf (vision_kernel.py:60-96,
//     including the 0xFFFFF000 bit-truncated sqrt head), not CUDA's acosf
//     nor the polynomial acos of the XLA stages;
//   * the gate S > sat_gate and I > int_gate, the bin floor(H (bins - 1)),
//     the cell of the pixel's static tile (row = x grid / wm, column =
//     (hm - 1 - y) grid / hm), and the per-cell histogram f32[cells, bins];
//   * the four clamp-to-edge 3x3 stencils on intensity, in the TPU kernel's
//     sums (west - east, south - north, 4 c - corners, the saddle);
//   * per cell, over the cell's band of cw = wm / cells columns:
//     sqrt(mean breathing^2), mean |vtilt|, mean |htilt|, max |saddle|.
// Every float operation is an explicit _rn intrinsic in the TPU kernel's
// order, so that no FMA contraction can move a hue across a bin edge: the
// HSI values equal the plain PyTorch version's bit for bit.
//
// What bounds it on the H100: memory, barely.  A 1080p mip (135 x 240) is
// 389 KB per frame read once and 23 KB written; at T = 64 that is ~26 MB
// (~8 us at 3.35 TB/s).  The ~100 operations per pixel (the acos, a sqrt,
// three divides) are ~3 GFLOP at T = 64, far under the f32 peak.
//
// What the design does about it — a simple, correct design first: one
// block of 1024 threads per frame.
//   1. The histogram is an integer histogram in shared memory (cells x bins
//      i32, 23 KB at 16 x 360) filled with atomicAdd over a block-stride
//      loop of the pixels: exact whatever the order, the Metal original's
//      form (the TPU kernel's 24 x 15 one-hot MXU split is not carried
//      over).
//   2. The gradient statistics: one warp per cell band, each lane owning
//      the band's columns lane, lane + 32, ... and walking them down the
//      rows with a rolling 3 x 3 window of intensities (read from the
//      planes, L1-cached), then a fixed shuffle tree across the lanes, so
//      that the result is the same from run to run.
//   3. The histogram is written out as f32.
// Filling all 132 SMs at small T and wider loads are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;

// fdlibm acosf constants (vaudio/ops/vision_kernel.py:60-65).
constexpr float kPio2Hi = 1.5707962513e+00f;
constexpr float kPio2Lo = 7.5497894159e-08f;
constexpr float kPS0 = 1.6666586697e-01f;
constexpr float kPS1 = -4.2743422091e-02f;
constexpr float kPS2 = -8.6563630030e-03f;
constexpr float kQS1 = -7.0662963390e-01f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kThird = 1.0f / 3.0f;

__device__ __forceinline__ float r_poly(float z) {
    const float p = __fmul_rn(
        z, __fadd_rn(kPS0, __fmul_rn(z, __fadd_rn(kPS1, __fmul_rn(z, kPS2)))));
    const float q = __fadd_rn(1.0f, __fmul_rn(z, kQS1));
    return __fdiv_rn(p, q);
}

// float32 acos on [-1, 1] from sqrt, divide and polynomial only.
__device__ float acos_fdlibm(float x) {
    if (fabsf(x) < 0.5f) {              // pi/2 - asin(x)
        const float z = __fmul_rn(x, x);
        return __fsub_rn(kPio2Hi,
                         __fsub_rn(x, __fsub_rn(kPio2Lo,
                                                __fmul_rn(x, r_poly(z)))));
    }
    if (x < 0.0f) {                     // pi - 2 asin(sqrt((1 + x) / 2))
        const float z = __fmul_rn(__fadd_rn(1.0f, x), 0.5f);
        const float s = __fsqrt_rn(z);
        return __fmul_rn(2.0f, __fsub_rn(
            kPio2Hi, __fadd_rn(s, __fsub_rn(__fmul_rn(r_poly(z), s),
                                            kPio2Lo))));
    }
    // 2 asin(sqrt((1 - x) / 2)), the sqrt split into a truncated head df
    // and an exact tail correction c.
    const float z = __fmul_rn(__fsub_rn(1.0f, x), 0.5f);
    const float s = __fsqrt_rn(z);
    const float df = __uint_as_float(__float_as_uint(s) & 0xFFFFF000u);
    const float denom = __fadd_rn(s, df);
    const float c = denom > 0.0f
        ? __fdiv_rn(__fsub_rn(z, __fmul_rn(df, df)), denom) : 0.0f;
    return __fmul_rn(2.0f, __fadd_rn(df, __fadd_rn(__fmul_rn(r_poly(z), s),
                                                    c)));
}

__device__ __forceinline__ float intensity(float r, float g, float b) {
    return __fmul_rn(__fadd_rn(__fadd_rn(r, g), b), kThird);
}

__global__ void __launch_bounds__(kThreads) vision_stats_kernel(
        const float* __restrict__ mips, float* __restrict__ hist_out,
        float* __restrict__ grads_out, int hm, int wm, int grid, int bins,
        float sat_gate, float int_gate) {
    extern __shared__ int s_hist[];
    const int cells = grid * grid;
    const int nbins = cells * bins;
    const int npix = hm * wm;
    const int t = blockIdx.x;
    const float* R = mips + static_cast<size_t>(t) * 3 * npix;
    const float* G = R + npix;
    const float* B = G + npix;

    for (int k = threadIdx.x; k < nbins; k += blockDim.x) s_hist[k] = 0;
    __syncthreads();

    // ---- 1. HSI, gate, bin, histogram (convolveFeatures.metal:14-38,
    // 132-165) ----
    const float bins_m1 = static_cast<float>(bins - 1);
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
        const float r = R[p], g = G[p], b = B[p];
        const float i = intensity(r, g, b);
        const float mn = fminf(r, fminf(g, b));
        const float s = i > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(mn, i)) : 0.0f;
        if (!(s > sat_gate && i > int_gate)) continue;
        const float rg = __fsub_rn(r, g), rb = __fsub_rn(r, b);
        const float num = __fmul_rn(0.5f, __fadd_rn(rg, rb));
        const float den = __fsqrt_rn(
            __fadd_rn(__fmul_rn(rg, rg), __fmul_rn(rb, __fsub_rn(g, b))));
        float h = 0.0f;
        if (den != 0.0f) {
            const float arg = fminf(fmaxf(__fdiv_rn(num, den), -1.0f), 1.0f);
            const float theta = acos_fdlibm(arg);
            h = __fdiv_rn(b <= g ? theta : __fsub_rn(kTwoPi, theta), kTwoPi);
        }
        const int bin = min(max(__float2int_rz(__fmul_rn(h, bins_m1)), 0),
                            bins - 1);
        const int y = p / wm, x = p - y * wm;
        const int cell = ((x * grid) / wm) * grid + ((hm - 1 - y) * grid) / hm;
        atomicAdd(&s_hist[cell * bins + bin], 1);
    }

    // ---- 2. intensity stencils and per-band statistics
    // (convolveFeatures.metal:94-113, VisionEngine.swift:273-295) ----
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int cw = wm / cells;
    const float n = static_cast<float>(hm * cw);
    for (int c = warp; c < cells; c += nwarps) {
        float sq = 0.0f, ay = 0.0f, az = 0.0f, mx = 0.0f;
        for (int x = c * cw + lane; x < (c + 1) * cw; x += 32) {
            const int xs[3] = {max(x - 1, 0), x, min(x + 1, wm - 1)};
            float t0[3], t1[3], t2[3];          // rows y - 1, y, y + 1
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                t0[d] = intensity(R[xs[d]], G[xs[d]], B[xs[d]]);
                t1[d] = t0[d];
                const int q = min(1, hm - 1) * wm + xs[d];
                t2[d] = intensity(R[q], G[q], B[q]);
            }
            for (int y = 0; y < hm; ++y) {
                const float west = __fadd_rn(__fadd_rn(t0[0], t1[0]), t2[0]);
                const float east = __fadd_rn(__fadd_rn(t0[2], t1[2]), t2[2]);
                const float north = __fadd_rn(__fadd_rn(t0[0], t0[1]), t0[2]);
                const float south = __fadd_rn(__fadd_rn(t2[0], t2[1]), t2[2]);
                const float breathing = __fsub_rn(
                    __fmul_rn(4.0f, t1[1]),
                    __fadd_rn(__fadd_rn(__fadd_rn(t0[0], t0[2]), t2[0]),
                              t2[2]));
                const float vtilt = __fsub_rn(west, east);
                const float htilt = __fsub_rn(south, north);
                const float saddle = __fsub_rn(__fadd_rn(t0[0], t2[2]),
                                               __fadd_rn(t0[2], t2[0]));
                sq = __fadd_rn(sq, __fmul_rn(breathing, breathing));
                ay = __fadd_rn(ay, fabsf(vtilt));
                az = __fadd_rn(az, fabsf(htilt));
                mx = fmaxf(mx, fabsf(saddle));
                const int next = min(y + 2, hm - 1) * wm;
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    t0[d] = t1[d];
                    t1[d] = t2[d];
                    const int q = next + xs[d];
                    t2[d] = intensity(R[q], G[q], B[q]);
                }
            }
        }
        for (int o = 16; o > 0; o >>= 1) {     // fixed tree over the lanes
            sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, o));
            ay = __fadd_rn(ay, __shfl_down_sync(0xffffffffu, ay, o));
            az = __fadd_rn(az, __shfl_down_sync(0xffffffffu, az, o));
            mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
        }
        if (lane == 0) {
            float* dst = grads_out + (static_cast<size_t>(t) * cells + c) * 4;
            dst[0] = __fsqrt_rn(__fdiv_rn(sq, n));
            dst[1] = __fdiv_rn(ay, n);
            dst[2] = __fdiv_rn(az, n);
            dst[3] = mx;
        }
    }
    __syncthreads();

    // ---- 3. the histogram out, as f32 ----
    float* hdst = hist_out + static_cast<size_t>(t) * nbins;
    for (int k = threadIdx.x; k < nbins; k += blockDim.x)
        hdst[k] = static_cast<float>(s_hist[k]);
}

}  // namespace

// mips f32[T, 3, hm, wm]; hist f32[T, grid^2, bins]; grads f32[T, grid^2,
// 4]; all contiguous on the device, wm a multiple of grid^2, hm, wm >= 2.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int vaudio_vision_stats(
        const void* mips, void* hist, void* grads, int T, int hm, int wm,
        int grid, int bins, float sat_gate, float int_gate, void* stream) {
    if (T <= 0) return cudaSuccess;
    const int cells = grid * grid;
    if (hm < 2 || wm < 2 || cells <= 0 || bins <= 0 || wm % cells != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(cells) * bins * sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            vision_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    vision_stats_kernel<<<T, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mips), static_cast<float*>(hist),
        static_cast<float*>(grads), hm, wm, grid, bins, sat_gate, int_gate);
    return static_cast<int>(cudaGetLastError());
}
