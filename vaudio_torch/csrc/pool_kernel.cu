// Kernel K1: the u8 mip pool.
//
// Replaces: vaudio/ops/pool_kernel.py, mip_pool_pallas (body _pool_kernel),
// the TPU kernel that box-pools each u8 channel plane in VMEM with int8
// MXU matmuls.
//
// What it computes: for u8 frames (T, H, W, 3), interleaved as they arrive,
// out[t, c, oy, ox] = (float)S * gain + offset, where S is the int32 sum of
// (v - 128) over the 2^l x 2^l block at (oy, ox) of channel c; rows and
// columns past the last full block are dropped.  The epilogue is one f32
// multiply and one f32 add, written with __fmul_rn / __fadd_rn so that FMA
// contraction cannot change its rounding (the JAX package rounds both).
//
// What bounds it on the H100: the read of device memory, 6.2 MB per 1080p
// frame against 0.1 MB of f32 output; the integer adds are ~1 per byte.
//
// What the design does about it: one thread per output texel sums all three
// channels of its block row by row, so the 32 threads of a warp read one
// contiguous run of 32 * 2^l * 3 bytes per row (neighbouring threads on
// neighbouring bytes), and every frame byte is read once.  The TPU kernel's
// XOR-0x80 int8 split, banded matmuls and VMEM budgets served the MXU and
// have no counterpart here: the block sum is exact in int32 directly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void mip_pool_u8_kernel(const uint8_t* __restrict__ frames,
                                   float* __restrict__ out, int H, int W,
                                   int level, float gain, float offset) {
    const int ho = H >> level;
    const int wo = W >> level;
    const int ox = blockIdx.x * kThreads + threadIdx.x;
    const int oy = blockIdx.y;
    const int t = blockIdx.z;
    if (ox >= wo) return;
    const int k = 1 << level;
    const size_t row_bytes = static_cast<size_t>(W) * 3;
    const uint8_t* src = frames
        + (static_cast<size_t>(t) * H + static_cast<size_t>(oy) * k)
          * row_bytes
        + static_cast<size_t>(ox) * k * 3;
    int s0 = 0, s1 = 0, s2 = 0;
    for (int dy = 0; dy < k; ++dy) {
        const uint8_t* p = src + dy * row_bytes;
        for (int dx = 0; dx < k; ++dx) {
            s0 += p[3 * dx];
            s1 += p[3 * dx + 1];
            s2 += p[3 * dx + 2];
        }
    }
    // Sum of (v - 128) over the k*k block, exactly as the JAX package.
    const int centre = 128 << (2 * level);
    const size_t plane = static_cast<size_t>(ho) * wo;
    float* dst = out + static_cast<size_t>(t) * 3 * plane
        + static_cast<size_t>(oy) * wo + ox;
    dst[0] = __fadd_rn(__fmul_rn(static_cast<float>(s0 - centre), gain),
                       offset);
    dst[plane] = __fadd_rn(__fmul_rn(static_cast<float>(s1 - centre), gain),
                           offset);
    dst[2 * plane] = __fadd_rn(
        __fmul_rn(static_cast<float>(s2 - centre), gain), offset);
}

// The planar entry: the TPU kernel's own form, u8 planes (N, H, W) in, one
// plane at a time (a YUV frame's Y, or its U and V).  The interleaved
// kernel above with a channel stride of 1: one thread per output texel, the
// warp's 32 threads on one contiguous run of 32 * 2^l bytes per row, an
// exact int32 sum, the same rounded epilogue.  What bounds it is again the
// read of the planes (1.5 bytes per luma pixel for a 4:2:0 frame).  Up to
// two plane batches of the same shape go in one launch (grid z = 2 N), so
// U and V share theirs.
__global__ void mip_pool_planes_kernel(const uint8_t* __restrict__ a,
                                       const uint8_t* __restrict__ b,
                                       float* __restrict__ out_a,
                                       float* __restrict__ out_b, int N,
                                       int H, int W, int level, float gain,
                                       float offset) {
    const int ho = H >> level;
    const int wo = W >> level;
    const int ox = blockIdx.x * kThreads + threadIdx.x;
    const int oy = blockIdx.y;
    const int z = blockIdx.z;
    if (ox >= wo) return;
    const bool second = z >= N;
    const int n = second ? z - N : z;
    const uint8_t* planes = second ? b : a;
    float* out = second ? out_b : out_a;
    const int k = 1 << level;
    const uint8_t* src = planes
        + (static_cast<size_t>(n) * H + static_cast<size_t>(oy) * k) * W
        + static_cast<size_t>(ox) * k;
    int s = 0;
    for (int dy = 0; dy < k; ++dy) {
        const uint8_t* p = src + static_cast<size_t>(dy) * W;
        for (int dx = 0; dx < k; ++dx) s += p[dx];
    }
    const int centre = 128 << (2 * level);
    out[(static_cast<size_t>(n) * ho + oy) * wo + ox] =
        __fadd_rn(__fmul_rn(static_cast<float>(s - centre), gain), offset);
}

}  // namespace

// a, b: u8 (N, H, W) contiguous (b may be null: one batch); out_a, out_b:
// f32 (N, H >> level, W >> level) contiguous.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int vaudio_mip_pool_planes_u8(const void* a, const void* b,
                                         void* out_a, void* out_b, int N,
                                         int H, int W, int level, float gain,
                                         float offset, void* stream) {
    const int ho = H >> level;
    const int wo = W >> level;
    if (N <= 0 || ho <= 0 || wo <= 0) return cudaSuccess;
    dim3 grid((wo + kThreads - 1) / kThreads, ho, b ? 2 * N : N);
    mip_pool_planes_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<float*>(out_a), static_cast<float*>(out_b), N, H, W,
        level, gain, offset);
    return static_cast<int>(cudaGetLastError());
}

// frames: u8 (T, H, W, 3) contiguous; out: f32 (T, 3, H >> level,
// W >> level) contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int vaudio_mip_pool_u8(const void* frames, void* out, int T,
                                  int H, int W, int level, float gain,
                                  float offset, void* stream) {
    const int ho = H >> level;
    const int wo = W >> level;
    if (T <= 0 || ho <= 0 || wo <= 0) return cudaSuccess;
    dim3 grid((wo + kThreads - 1) / kThreads, ho, T);
    mip_pool_u8_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(frames), static_cast<float*>(out), H, W,
        level, gain, offset);
    return static_cast<int>(cudaGetLastError());
}
