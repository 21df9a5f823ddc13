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
//     and the per-cell histogram f32[cells, bins] over the cells' static
//     tiles (row = x grid / wm, column = (hm - 1 - y) grid / hm);
//   * the four clamp-to-edge 3x3 stencils on intensity, in the TPU kernel's
//     sums (west - east, south - north, 4 c - corners, the saddle);
//   * per cell, over the cell's band of cw = wm / cells columns:
//     sqrt(mean breathing^2), mean |vtilt|, mean |htilt|, max |saddle|.
// Every float operation is an explicit _rn intrinsic in the TPU kernel's
// order, so that no FMA contraction can move a hue across a bin edge: the
// HSI values equal the plain PyTorch version's bit for bit.
//
// What bounds it on the H100: latency at the live paths' small T, memory
// at large T.  A 1080p mip (135 x 240) is 389 KB per frame read once and
// 23 KB written (~8 us at T = 64 and 3.35 TB/s); the ~90 operations per
// pixel (the acos, a sqrt, three divides) are far under the f32 peak.  The
// first draft ran one block of 1024 threads per frame (1 SM of 132 at
// T = 1), and walked each cell band's 135 rows serially with one lane per
// column (15 of 32 lanes busy at cw = 15): ~0.07 ms at any T.  In this
// design the histogram blocks and the band blocks each read every pixel,
// so at large T the mip crosses the memory bus twice.
//
// What the design does about it: a grid of (2 cells, T) blocks of 256
// threads, each block working on one rectangle of a host-built table
// (i32 [2 cells, 4] of y0, rows, x0, columns):
//   * blocks 0 .. cells - 1: the histogram of cell c over its static tile
//     (the TPU kernel's tiles, vaudio/ops/vision_kernel.py:298-304).  The
//     counts are i32 in shared memory, added with shared-memory atomics
//     (one for a warp whose pixels share a bin); the block writes its row
//     of the histogram as f32 itself (no global atomics, no memset);
//   * blocks cells .. 2 cells - 1: the gradient band c.  The block stages
//     the band's intensities in shared memory in tiles of rows x columns
//     with a one-pixel halo clamped at the image edge (16 KB whatever the
//     mip's size); every thread walks a run of rows down one column of the
//     tile with a rolling 3 x 3 window (three shared loads a pixel), and
//     the per-thread sums are reduced by a fixed tree: shuffles, then the
//     warps' sums in warp order.
// Both kinds of block step through their rectangles by additions (no
// integer division per pixel).
// The tiling depends only on (hm, wm, grid), never on T, and no float sum
// uses atomics: each frame's result is the same bits at any T and from run
// to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 4096;      // a band block's intensity tile
constexpr int kTileMaxCols = 126;      // columns of a tile, halo excluded

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

// HSI, gate and bin of one pixel (convolveFeatures.metal:14-38, 132-165):
// the bin, or -1 where the gate drops the pixel.
__device__ __forceinline__ int hue_bin(float r, float g, float b, int bins,
                                       float sat_gate, float int_gate) {
    const float i = intensity(r, g, b);
    const float mn = fminf(r, fminf(g, b));
    const float s = i > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(mn, i)) : 0.0f;
    if (!(s > sat_gate && i > int_gate)) return -1;
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
    return min(max(__float2int_rz(__fmul_rn(h, static_cast<float>(bins - 1))),
                   0), bins - 1);
}

// A thread's walk over a rows x cols rectangle in row-major order, kThreads
// elements a step: its (row, column) advances by additions, without a
// division per element.
struct Walk {
    int row, col, step_rows, step_cols, cols;
    __device__ explicit Walk(int c) : cols(c) {
        row = threadIdx.x / c;
        col = threadIdx.x - row * c;
        step_rows = kThreads / c;
        step_cols = kThreads - step_rows * c;
    }
    __device__ void next() {
        row += step_rows;
        col += step_cols;
        if (col >= cols) { col -= cols; ++row; }
    }
};

// Blocks 0 .. cells - 1: the hue histogram of one cell's tile.
__device__ void cell_histogram(const float* R, const float* G,
                               const float* B, int4 tile, int wm, int bins,
                               float sat_gate, float int_gate, int* s_hist,
                               float* dst) {
    const int y0 = tile.x, x0 = tile.z, n = tile.y * tile.w;
    const int lane = threadIdx.x & 31;
    for (int k = threadIdx.x; k < bins; k += kThreads) s_hist[k] = 0;
    __syncthreads();
    Walk at(max(tile.w, 1));
    for (int q0 = 0; q0 < n; q0 += kThreads, at.next()) {  // uniform count
        int bin = -1;
        if (q0 + threadIdx.x < n) {
            const int p = (y0 + at.row) * wm + x0 + at.col;
            bin = hue_bin(R[p], G[p], B[p], bins, sat_gate, int_gate);
        }
        // A warp whose pixels share one bin adds 32 at once (a uniform
        // region of the frame); otherwise each lane adds its own.
        const int first = __shfl_sync(0xffffffffu, bin, 0);
        if (__all_sync(0xffffffffu, bin == first)) {
            if (lane == 0 && first >= 0) atomicAdd(&s_hist[first], 32);
        } else if (bin >= 0) {
            atomicAdd(&s_hist[bin], 1);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < bins; k += kThreads)
        dst[k] = static_cast<float>(s_hist[k]);
}

// Blocks cells .. 2 cells - 1: the stencils and statistics of one band.
__device__ void band_stats(const float* R, const float* G, const float* B,
                           int4 band, int hm, int wm, float* s_i,
                           float* dst) {
    __shared__ float s_red[kWarps][4];
    const int y0 = band.x, y1 = band.x + band.y;
    const int x0 = band.z, x1 = band.z + band.w;
    const int cols = min(band.w, kTileMaxCols);
    const int rows = kTileFloats / (cols + 2) - 2;     // >= 30
    float sq = 0.0f, ay = 0.0f, az = 0.0f, mx = 0.0f;
    for (int xs = x0; xs < x1; xs += cols) {
        const int cn = min(cols, x1 - xs), w2 = cn + 2;
        for (int ys = y0; ys < y1; ys += rows) {
            const int rn = min(rows, y1 - ys), tn = (rn + 2) * w2;
            __syncthreads();                   // the last tile is consumed
            Walk at(w2);
            for (int i = threadIdx.x; i < tn; i += kThreads, at.next()) {
                const int gy = min(max(ys - 1 + at.row, 0), hm - 1);
                const int gx = min(max(xs - 1 + at.col, 0), wm - 1);
                const int p = gy * wm + gx;
                s_i[i] = intensity(R[p], G[p], B[p]);
            }
            __syncthreads();
            // Each thread walks a run of rows down one column (cn <= 126,
            // so every column has at least two runs) with a rolling window
            // of the rows above, at and below the pixel.
            const int runs = kThreads / cn;
            const int run_rows = (rn + runs - 1) / runs;
            const int x = threadIdx.x % cn, run = threadIdx.x / cn;
            const int ya = run * run_rows;
            const int yb = run < runs ? min(rn, ya + run_rows) : ya;
            if (ya < yb) {
                const float* c = s_i + ya * w2 + x;
                float t0[3] = {c[0], c[1], c[2]};
                float t1[3] = {c[w2], c[w2 + 1], c[w2 + 2]};
                for (int y = ya; y < yb; ++y) {
                    c += w2;
                    const float t2[3] = {c[w2], c[w2 + 1], c[w2 + 2]};
                    const float west = __fadd_rn(__fadd_rn(t0[0], t1[0]),
                                                 t2[0]);
                    const float east = __fadd_rn(__fadd_rn(t0[2], t1[2]),
                                                 t2[2]);
                    const float north = __fadd_rn(__fadd_rn(t0[0], t0[1]),
                                                  t0[2]);
                    const float south = __fadd_rn(__fadd_rn(t2[0], t2[1]),
                                                  t2[2]);
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
#pragma unroll
                    for (int d = 0; d < 3; ++d) {
                        t0[d] = t1[d];
                        t1[d] = t2[d];
                    }
                }
            }
        }
    }
    for (int o = 16; o > 0; o >>= 1) {          // fixed tree over the lanes
        sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, o));
        ay = __fadd_rn(ay, __shfl_down_sync(0xffffffffu, ay, o));
        az = __fadd_rn(az, __shfl_down_sync(0xffffffffu, az, o));
        mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_red[warp][0] = sq;
        s_red[warp][1] = ay;
        s_red[warp][2] = az;
        s_red[warp][3] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {                     // then the warps in order
        for (int v = 1; v < kWarps; ++v) {
            sq = __fadd_rn(sq, s_red[v][0]);
            ay = __fadd_rn(ay, s_red[v][1]);
            az = __fadd_rn(az, s_red[v][2]);
            mx = fmaxf(mx, s_red[v][3]);
        }
        const float n = static_cast<float>(band.y * band.w);
        dst[0] = __fsqrt_rn(__fdiv_rn(sq, n));
        dst[1] = __fdiv_rn(ay, n);
        dst[2] = __fdiv_rn(az, n);
        dst[3] = mx;
    }
}

__global__ void __launch_bounds__(kThreads) vision_stats_kernel(
        const float* __restrict__ mips, const int4* __restrict__ rects,
        float* __restrict__ hist_out, float* __restrict__ grads_out, int hm,
        int wm, int cells, int bins, float sat_gate, float int_gate) {
    extern __shared__ float smem[];
    const int c = blockIdx.x, t = blockIdx.y;
    const size_t npix = static_cast<size_t>(hm) * wm;
    const float* R = mips + static_cast<size_t>(t) * 3 * npix;
    const float* G = R + npix;
    const float* B = G + npix;
    if (c < cells) {
        cell_histogram(R, G, B, rects[c], wm, bins, sat_gate, int_gate,
                       reinterpret_cast<int*>(smem),
                       hist_out + (static_cast<size_t>(t) * cells + c) * bins);
    } else {
        band_stats(R, G, B, rects[c], hm, wm, smem,
                   grads_out + (static_cast<size_t>(t) * cells + c - cells)
                               * 4);
    }
}

}  // namespace

// mips f32[T, 3, hm, wm]; rects i32[2 cells, 4] (y0, rows, x0, columns): the
// cells' histogram tiles, then their gradient bands; hist f32[T, cells,
// bins]; grads f32[T, cells, 4]; all contiguous on the device, hm, wm >= 2.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int vaudio_vision_stats(
        const void* mips, const void* rects, void* hist, void* grads, int T,
        int hm, int wm, int cells, int bins, float sat_gate, float int_gate,
        void* stream) {
    if (T <= 0) return cudaSuccess;
    if (hm < 2 || wm < 2 || cells <= 0 || bins <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * static_cast<size_t>(
        bins > kTileFloats ? bins : kTileFloats);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            vision_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    vision_stats_kernel<<<dim3(2 * cells, T), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mips), static_cast<const int4*>(rects),
        static_cast<float*>(hist), static_cast<float*>(grads), hm, wm, cells,
        bins, sat_gate, int_gate);
    return static_cast<int>(cudaGetLastError());
}
