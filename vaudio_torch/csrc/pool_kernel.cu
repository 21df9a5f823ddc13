// Kernel K1: the u8 mip pool, with its interleaved RGB, planar and fused
// YUV 4:2:0 entries.
//
// Replaces: vaudio/ops/pool_kernel.py, mip_pool_pallas (body _pool_kernel),
// the TPU kernel that box-pools each u8 channel plane in VMEM with int8
// MXU matmuls; and, in the YUV entry, the conversion that
// vaudio/vision/features.py::yuv420_mip_to_rgb_planes runs on its mips.
//
// What it computes: S, the int32 sum of (v - 128) over each 2^l x 2^l block
// of a u8 plane (rows and columns past the last full block dropped), then
// (float)S * gain + offset, the multiply and the add each rounded
// (__fmul_rn / __fadd_rn: no FMA contraction, as the JAX package rounds
// both).  Three entries:
//   * mip_pool_u8_kernel: u8 frames (T, H, W, 3), interleaved as they
//     arrive -> f32 (T, 3, H >> l, W >> l);
//   * mip_pool_planes_kernel: u8 planes (N, H, W) -> f32 (N, H >> l,
//     W >> l);
//   * mip_pool_yuv420_kernel: one YUV 4:2:0 dispatch, u8 Y (T, H, W) and U,
//     V (T, Hc, Wc) -> clamped RGB mips f32 (T, 3, hm, wm), hm = H >> l,
//     wm = W >> l: Y pooled at l and U, V at l - 1 with K1's epilogue (at
//     l - 1 = 0 the chroma is not pooled, and its value is v * scale, the
//     JAX package's unpooled form, not the epilogue's
//     (v - 128) scale + 128 scale), the separate offset adds, the chroma
//     cropped to (hm, wm), BT.601 as separate rounded products and sums in
//     the order of yuv420_mip_to_rgb_planes, and the clamp to [0, 1].  The
//     intermediates never reach device memory.
//
// What bounds it on the H100: the bytes.  A 1080p frame is 6.2 MB of RGB
// (3.1 MB of YUV) read once against 0.39 MB of f32 mips written; the
// integer adds are ~1 per byte.  So the card must keep enough bytes in
// flight on every SM.  The PR 1 design (one thread per output texel, one
// byte loaded per instruction, 2^l x 3 loads a row) kept few bytes in
// flight a thread and needed two launches and 13 elementwise kernels per
// YUV dispatch: 61-69% of the bound at T = 8..64, 18% for one YUV frame.
//
// What the design does about it: one block owns one output row of one
// frame, or one column tile of it: the band of 2^l frame rows that feeds
// it, for every plane it reads.
//   0. Staging.  The band is cut into 16-byte chunks of its rows; a thread
//      takes one chunk and copies it from every row of the band into shared
//      memory with cp.async (up to 8 rows at a time), so all of a block's
//      band is in flight at once and holds no registers: the bytes in
//      flight on an SM are bounded by its shared memory, not by its
//      registers (loading the rows into registers instead, 8 x 16 bytes a
//      thread, held the YUV entry to 4 blocks an SM and 66% of the bound).
//   1. Column sums.  Each thread sums the rows it staged itself (no
//      barrier between), column by column, in 16-bit lanes of two 32-bit
//      registers (a lane holds at most 128 x 255), and stores its 16 sums
//      as u16.  A band whose rows are not 16-byte aligned (a width W or
//      3 W that is not a multiple of 16, or an offset base) loads its bytes
//      one by one into the same sums, inside the kernel.
//   2. Block sums.  A thread per output texel sums the 2^l column sums of
//      each channel with 4- to 16-byte shared reads (a texel's column sums
//      are contiguous, so a warp's reads do not conflict) and runs the
//      epilogue (for YUV also the conversion) in registers.
// Rows are cut into column tiles (multiples of 16 texels) where a whole row
// would pass 64 KB of shared memory, and where the launch would have fewer
// than 4 blocks an SM: at 1080p, mip 3, T = 1 that is 4 tiles of each of
// the 135 rows (540 blocks for 132 SMs, not 135 with a second wave of 3).
// The integer sums are exact, so every output is the same bits at any T
// and for any tiling.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
// Rows of a band staged in shared memory at a time (a band of more rows,
// mip level 4 and up, is summed in groups of this many).
constexpr int kGroup = 8;
// Shared memory a block may take; a wider row is cut into column tiles.
constexpr int kSmemBudget = 64 * 1024;
// Blocks a launch should have per SM, cutting rows into column tiles when
// there are fewer output rows than that (T = 1).
constexpr int kBlocksPerSm = 4;

// One plane's band: the rows that feed one output row of one tile, and
// where its chunks go in shared memory: the u16 column sums (32 bytes a
// chunk), then the staged rows (kGroup rows of 16 bytes a chunk, the
// chunks of a row side by side).
struct Band {
    const uint8_t* src;   // first byte of the band's first row
    size_t pitch;         // bytes from one row to the next
    int rows;             // 2^level
    int used;             // bytes of each row that are summed
    int chunks;           // 16-byte chunks of `used`
    bool aligned;         // src and pitch 16-byte aligned
    uint16_t* colsum;
    uint8_t* stage;
};

// Shared-memory bytes a band takes for each byte of its rows' width: two
// for its u16 column sums, one for each row staged at a time.
__host__ __device__ __forceinline__ int smem_per_byte(int rows) {
    return 2 + (rows < kGroup ? rows : kGroup);
}

// Shared-memory bytes of a band of `chunks` chunks and `rows` rows.
__host__ __device__ __forceinline__ int band_smem(int chunks, int rows) {
    return 16 * chunks * smem_per_byte(rows);
}

__host__ __device__ __forceinline__ int chunks_of(int used) {
    return (used + 15) >> 4;
}

__device__ __forceinline__ Band make_band(const uint8_t* src, size_t pitch,
                                          int rows, int used,
                                          uint8_t* smem) {
    const int chunks = chunks_of(used);
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(src) | pitch) & 15u) == 0;
    return Band{src, pitch, rows, used, chunks, aligned,
                reinterpret_cast<uint16_t*>(smem), smem + 32 * chunks};
}

// 16 bytes global -> shared, asynchronously (cached in L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Waits for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

// Stages rows r0 .. r0 + kGroup - 1 (those the band has) of chunk c.
__device__ __forceinline__ void stage_rows(const Band& b, int c, int r0) {
    const int n = min(kGroup, b.rows - r0);
    const uint8_t* p = b.src + 16 * c + r0 * b.pitch;
    uint8_t* s = b.stage + 16 * c;
    for (int r = 0; r < n; ++r)
        cp_async16(s + r * 16 * b.chunks, p + r * b.pitch);
}

// Adds the 16 bytes of v column by column: lo[i] holds bytes 0 and 2 of
// word i in its 16-bit lanes, hi[i] bytes 1 and 3.
__device__ __forceinline__ void add_bytes(uint4 v, uint32_t (&lo)[4],
                                          uint32_t (&hi)[4]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        lo[i] += w[i] & 0x00FF00FFu;
        hi[i] += (w[i] >> 8) & 0x00FF00FFu;
    }
}

// The 16 column sums of chunk c, as u16 in byte order, at colsum + 16 c.
__device__ __forceinline__ void store_sums(const uint32_t (&lo)[4],
                                           const uint32_t (&hi)[4],
                                           uint16_t* colsum, int c) {
    uint4* dst = reinterpret_cast<uint4*>(colsum + 16 * c);
    dst[0] = make_uint4(__byte_perm(lo[0], hi[0], 0x5410),
                        __byte_perm(lo[0], hi[0], 0x7632),
                        __byte_perm(lo[1], hi[1], 0x5410),
                        __byte_perm(lo[1], hi[1], 0x7632));
    dst[1] = make_uint4(__byte_perm(lo[2], hi[2], 0x5410),
                        __byte_perm(lo[2], hi[2], 0x7632),
                        __byte_perm(lo[3], hi[3], 0x5410),
                        __byte_perm(lo[3], hi[3], 0x7632));
}

// Column sums of an aligned chunk from its staged rows (the first group
// staged and waited for by this same thread; later groups staged here).
__device__ __forceinline__ void staged_sums(const Band& b, int c) {
    uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
    const uint4* s = reinterpret_cast<const uint4*>(b.stage) + c;
    for (int r0 = 0; r0 < b.rows; r0 += kGroup) {
        if (r0 > 0) {
            stage_rows(b, c, r0);
            cp_async_wait_all();
        }
        const int n = min(kGroup, b.rows - r0);
        for (int r = 0; r < n; ++r) add_bytes(s[r * b.chunks], lo, hi);
    }
    store_sums(lo, hi, b.colsum, c);
}

// Column sums of a chunk whose rows are not 16-byte aligned: the bytes
// below `used` loaded one by one, row by row.
__device__ __forceinline__ void unaligned_sums(const Band& b, int c) {
    uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
    const uint8_t* p = b.src + 16 * c;
    const int valid = b.used - 16 * c;
    for (int r = 0; r < b.rows; ++r, p += b.pitch) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
            if (j < valid)
                w[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
        add_bytes(make_uint4(w[0], w[1], w[2], w[3]), lo, hi);
    }
    store_sums(lo, hi, b.colsum, c);
}

// Phases 0 and 1: the column sums of every band into shared memory.  The
// chunks of all bands are spread over the block's threads; each thread
// first stages the first row group of each of its aligned chunks (all of
// the block's copies in flight at once, none held in registers), waits
// for its own copies, then sums what it staged itself, so no barrier
// stands between the two.
template <int kBands>
__device__ __forceinline__ void column_sums(const Band (&bands)[kBands]) {
    int total = 0;
#pragma unroll
    for (int b = 0; b < kBands; ++b) total += bands[b].chunks;
    for (int task = threadIdx.x; task < total; task += blockDim.x) {
        int c = task;
#pragma unroll
        for (int b = 0; b < kBands; ++b) {
            if (c >= 0 && c < bands[b].chunks && bands[b].aligned)
                stage_rows(bands[b], c, 0);
            c -= bands[b].chunks;
        }
    }
    cp_async_wait_all();
    for (int task = threadIdx.x; task < total; task += blockDim.x) {
        int c = task;
#pragma unroll
        for (int b = 0; b < kBands; ++b) {
            if (c >= 0 && c < bands[b].chunks) {
                if (bands[b].aligned)
                    staged_sums(bands[b], c);
                else
                    unaligned_sums(bands[b], c);
            }
            c -= bands[b].chunks;
        }
    }
}

// V consecutive u16 from p (2 V-byte aligned) as 32-bit values.
template <int V>
__device__ __forceinline__ void load_u16s(const uint16_t* p,
                                          uint32_t (&e)[V]) {
    if constexpr (V == 8) {
        const uint4 w = *reinterpret_cast<const uint4*>(p);
        const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            e[2 * i] = x[i] & 0xFFFFu;
            e[2 * i + 1] = x[i] >> 16;
        }
    } else if constexpr (V == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        e[0] = w.x & 0xFFFFu;
        e[1] = w.x >> 16;
        e[2] = w.y & 0xFFFFu;
        e[3] = w.y >> 16;
    } else if constexpr (V == 2) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
        e[0] = w & 0xFFFFu;
        e[1] = w >> 16;
    } else {
        e[0] = *p;
    }
}

// s[c] = the sum of the n column sums at p whose index j has j % C == c;
// n is a multiple of C V.
template <int C, int V>
__device__ __forceinline__ void run_sums(const uint16_t* p, int n,
                                         int (&s)[C]) {
    for (int i = 0; i < n; i += C * V) {
#pragma unroll
        for (int q = 0; q < C; ++q) {
            uint32_t e[V];
            load_u16s<V>(p + i + q * V, e);
#pragma unroll
            for (int j = 0; j < V; ++j) s[(q * V + j) % C] += e[j];
        }
    }
}

// Phase 2: the block sums of texel i of a band of C interleaved channels
// pooled by k: the k C column sums at colsum + i k C, read as wide as
// their alignment allows.
template <int C>
__device__ __forceinline__ void block_sums(const uint16_t* colsum, int i,
                                           int k, int (&s)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = 0;
    const int n = k * C;
    const uint16_t* p = colsum + i * n;
    if (n % 8 == 0)
        run_sums<C, 8>(p, n, s);
    else if (n % 4 == 0)
        run_sums<C, 4>(p, n, s);
    else if (n % 2 == 0)
        run_sums<C, 2>(p, n, s);
    else
        run_sums<C, 1>(p, n, s);
}

// K1's epilogue on a centred block sum.
__device__ __forceinline__ float epilogue(int centred, float gain,
                                          float offset) {
    return __fadd_rn(__fmul_rn(static_cast<float>(centred), gain), offset);
}

__global__ void __launch_bounds__(kMaxThreads)
mip_pool_u8_kernel(const uint8_t* __restrict__ frames,
                   float* __restrict__ out, int H, int W, int level,
                   int tile, float gain, float offset) {
    extern __shared__ uint4 smem[];
    const int k = 1 << level;
    const int ho = H >> level;
    const int wo = W >> level;
    const int ox0 = blockIdx.x * tile;
    const int n_out = min(tile, wo - ox0);
    const int oy = blockIdx.y;
    const int t = blockIdx.z;
    const size_t pitch = static_cast<size_t>(W) * 3;
    const Band bands[1] = {make_band(
        frames + (static_cast<size_t>(t) * H + static_cast<size_t>(oy) * k)
                     * pitch
            + static_cast<size_t>(ox0) * k * 3,
        pitch, k, n_out * k * 3, reinterpret_cast<uint8_t*>(smem))};
    column_sums<1>(bands);
    __syncthreads();
    const int centre = 128 << (2 * level);
    const size_t plane = static_cast<size_t>(ho) * wo;
    float* dst = out + static_cast<size_t>(t) * 3 * plane
        + static_cast<size_t>(oy) * wo + ox0;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        int s[3];
        block_sums<3>(bands[0].colsum, i, k, s);
        dst[i] = epilogue(s[0] - centre, gain, offset);
        dst[plane + i] = epilogue(s[1] - centre, gain, offset);
        dst[2 * plane + i] = epilogue(s[2] - centre, gain, offset);
    }
}

__global__ void __launch_bounds__(kMaxThreads)
mip_pool_planes_kernel(const uint8_t* __restrict__ planes,
                       float* __restrict__ out, int H, int W, int level,
                       int tile, float gain, float offset) {
    extern __shared__ uint4 smem[];
    const int k = 1 << level;
    const int ho = H >> level;
    const int wo = W >> level;
    const int ox0 = blockIdx.x * tile;
    const int n_out = min(tile, wo - ox0);
    const int oy = blockIdx.y;
    const int n = blockIdx.z;
    const Band bands[1] = {make_band(
        planes + (static_cast<size_t>(n) * H + static_cast<size_t>(oy) * k)
                     * W
            + static_cast<size_t>(ox0) * k,
        static_cast<size_t>(W), k, n_out * k,
        reinterpret_cast<uint8_t*>(smem))};
    column_sums<1>(bands);
    __syncthreads();
    const int centre = 128 << (2 * level);
    float* dst = out + (static_cast<size_t>(n) * ho + oy) * wo + ox0;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        int s[1];
        block_sums<1>(bands[0].colsum, i, k, s);
        dst[i] = epilogue(s[0] - centre, gain, offset);
    }
}

// The YUV entry's constants, folded on the host as the JAX package's f32
// values.
struct YuvConsts {
    float y_gain, y_offset, y_add;  // Y: the epilogue at l, then + y_add
    float c_gain, c_offset, c_add;  // U, V: the epilogue at l - 1 (at 0,
                                    // v * c_gain), then + c_add
    float kr, kgu, kgv, kb;         // R = Y + kr V, G = Y - kgu U - kgv V,
                                    // B = Y + kb U
};

__global__ void __launch_bounds__(kMaxThreads)
mip_pool_yuv420_kernel(const uint8_t* __restrict__ y,
                       const uint8_t* __restrict__ u,
                       const uint8_t* __restrict__ v,
                       float* __restrict__ out, int H, int W, int Hc, int Wc,
                       int level, int tile, YuvConsts c) {
    extern __shared__ uint4 smem[];
    const int k = 1 << level;
    const int kc = k >> 1;
    const int hm = H >> level;
    const int wm = W >> level;
    const int ox0 = blockIdx.x * tile;
    const int n_out = min(tile, wm - ox0);
    const int oy = blockIdx.y;
    const int t = blockIdx.z;
    const size_t chroma_at = (static_cast<size_t>(t) * Hc
                              + static_cast<size_t>(oy) * kc) * Wc
        + static_cast<size_t>(ox0) * kc;
    // Each band's region is sized for the widest tile.
    uint8_t* const sy = reinterpret_cast<uint8_t*>(smem);
    uint8_t* const su = sy + band_smem(chunks_of(tile * k), k);
    uint8_t* const sv = su + band_smem(chunks_of(tile * kc), kc);
    const Band bands[3] = {
        make_band(y + (static_cast<size_t>(t) * H
                       + static_cast<size_t>(oy) * k) * W
                      + static_cast<size_t>(ox0) * k,
                  static_cast<size_t>(W), k, n_out * k, sy),
        make_band(u + chroma_at, static_cast<size_t>(Wc), kc, n_out * kc,
                  su),
        make_band(v + chroma_at, static_cast<size_t>(Wc), kc, n_out * kc,
                  sv)};
    column_sums<3>(bands);
    __syncthreads();
    const int y_centre = 128 << (2 * level);
    const int c_centre = level > 1 ? 128 << (2 * (level - 1)) : 0;
    const size_t plane = static_cast<size_t>(hm) * wm;
    float* dst = out + static_cast<size_t>(t) * 3 * plane
        + static_cast<size_t>(oy) * wm + ox0;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        int ys[1], us[1], vs[1];
        block_sums<1>(bands[0].colsum, i, k, ys);
        block_sums<1>(bands[1].colsum, i, kc, us);
        block_sums<1>(bands[2].colsum, i, kc, vs);
        const float my = __fadd_rn(epilogue(ys[0] - y_centre, c.y_gain,
                                            c.y_offset), c.y_add);
        float mu, mv;
        if (level > 1) {
            mu = epilogue(us[0] - c_centre, c.c_gain, c.c_offset);
            mv = epilogue(vs[0] - c_centre, c.c_gain, c.c_offset);
        } else {        // chroma at level 0: not pooled, v * scale
            mu = __fmul_rn(static_cast<float>(us[0]), c.c_gain);
            mv = __fmul_rn(static_cast<float>(vs[0]), c.c_gain);
        }
        mu = __fadd_rn(mu, c.c_add);
        mv = __fadd_rn(mv, c.c_add);
        const float r = __fadd_rn(my, __fmul_rn(c.kr, mv));
        const float g = __fsub_rn(__fsub_rn(my, __fmul_rn(c.kgu, mu)),
                                  __fmul_rn(c.kgv, mv));
        const float bl = __fadd_rn(my, __fmul_rn(c.kb, mu));
        dst[i] = fminf(fmaxf(r, 0.0f), 1.0f);
        dst[plane + i] = fminf(fmaxf(g, 0.0f), 1.0f);
        dst[2 * plane + i] = fminf(fmaxf(bl, 0.0f), 1.0f);
    }
}

// A plane read by an entry: `bytes` bytes a texel in each of `rows` band
// rows (k C for the interleaved entry, k for a planar one).
struct PlaneShape {
    int bytes, rows;
};

// The launch of an entry whose output rows are wo texels wide, with
// `rows_out` output rows in `z` batches: the column tile (every column, or
// a multiple of 16 texels, so that each tile's bands start 16-byte
// aligned), the tiles, the shared memory of a block and its threads (one
// per chunk of the widest tile, in whole warps; the texels are looped
// over).  Rows are cut into tiles where a whole row would pass the
// shared-memory budget, and where there are fewer than kBlocksPerSm
// blocks per SM.
template <int kPlanes>
struct Launch {
    int tile, tiles, smem, threads;

    Launch(int wo, int rows_out, int z,
           const PlaneShape (&planes)[kPlanes]) {
        int per_texel = 0;
        for (const PlaneShape& p : planes)
            per_texel += p.bytes * smem_per_byte(p.rows);
        // At least 16 texels (61 KB at level 7 RGB, 3840 bytes a texel).
        const int fit = kSmemBudget / per_texel / 16 * 16;
        const int most = fit > 16 ? fit : 16;
        tile = wo <= most ? wo : most;
        static int sms = 0;
        if (sms == 0) {
            int dev = 0;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
            if (sms <= 0) sms = 132;
        }
        const long long rows = static_cast<long long>(rows_out) * z;
        const long long want = static_cast<long long>(kBlocksPerSm) * sms;
        if (rows * ((wo + tile - 1) / tile) < want) {
            const long long cuts = (want + rows - 1) / rows;
            const int narrow = static_cast<int>(
                ((wo + cuts - 1) / cuts + 15) / 16 * 16);
            if (narrow < tile) tile = narrow;
        }
        tiles = (wo + tile - 1) / tile;
        smem = 0;
        int chunks = 0;
        for (const PlaneShape& p : planes) {
            const int c = chunks_of(tile * p.bytes);
            smem += band_smem(c, p.rows);
            chunks += c;
        }
        const int warps = (chunks + 31) / 32;
        threads = warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
    }
};

// Each entry's launch for z frames (planes) of H x W at `level`.
Launch<1> rgb_launch(int z, int H, int W, int level) {
    const int k = 1 << level;
    const PlaneShape planes[1] = {{3 * k, k}};
    return Launch<1>(W >> level, H >> level, z, planes);
}

Launch<1> planes_launch(int z, int H, int W, int level) {
    const int k = 1 << level;
    const PlaneShape planes[1] = {{k, k}};
    return Launch<1>(W >> level, H >> level, z, planes);
}

Launch<3> yuv420_launch(int z, int H, int W, int level) {
    const int k = 1 << level;
    const PlaneShape planes[3] = {{k, k}, {k >> 1, k >> 1},
                                  {k >> 1, k >> 1}};
    return Launch<3>(W >> level, H >> level, z, planes);
}

template <int kPlanes>
void write_plan(const Launch<kPlanes>& launch, int* plan) {
    plan[0] = launch.tile;
    plan[1] = launch.tiles;
    plan[2] = launch.smem;
    plan[3] = launch.threads;
}

bool grid_fits(int ho, int z) { return ho <= 65535 && z <= 65535; }

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only on request); `allowed` is what it was last allowed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int& allowed) {
    if (smem <= allowed) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) allowed = smem;
    return err;
}

int u8_smem = 48 * 1024;
int planes_smem = 48 * 1024;
int yuv420_smem = 48 * 1024;

}  // namespace

// frames: u8 (T, H, W, 3) contiguous; out: f32 (T, 3, H >> level,
// W >> level) contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int vaudio_mip_pool_u8(const void* frames, void* out, int T,
                                  int H, int W, int level, float gain,
                                  float offset, void* stream) {
    const int ho = H >> level;
    const int wo = W >> level;
    if (T <= 0 || ho <= 0 || wo <= 0) return cudaSuccess;
    if (!grid_fits(ho, T)) return cudaErrorInvalidConfiguration;
    const Launch<1> launch = rgb_launch(T, H, W, level);
    const cudaError_t err =
        allow_smem(mip_pool_u8_kernel, launch.smem, u8_smem);
    if (err != cudaSuccess) return err;
    dim3 grid(launch.tiles, ho, T);
    mip_pool_u8_kernel<<<grid, launch.threads, launch.smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(frames), static_cast<float*>(out), H, W,
        level, launch.tile, gain, offset);
    return static_cast<int>(cudaGetLastError());
}

// planes: u8 (N, H, W) contiguous; out: f32 (N, H >> level, W >> level)
// contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int vaudio_mip_pool_planes_u8(const void* planes, void* out,
                                         int N, int H, int W, int level,
                                         float gain, float offset,
                                         void* stream) {
    const int ho = H >> level;
    const int wo = W >> level;
    if (N <= 0 || ho <= 0 || wo <= 0) return cudaSuccess;
    if (!grid_fits(ho, N)) return cudaErrorInvalidConfiguration;
    const Launch<1> launch = planes_launch(N, H, W, level);
    const cudaError_t err =
        allow_smem(mip_pool_planes_kernel, launch.smem, planes_smem);
    if (err != cudaSuccess) return err;
    dim3 grid(launch.tiles, ho, N);
    mip_pool_planes_kernel<<<grid, launch.threads, launch.smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(planes), static_cast<float*>(out), H, W,
        level, launch.tile, gain, offset);
    return static_cast<int>(cudaGetLastError());
}

// The launch an entry takes for T frames (planes) of H x W at `level`:
// entry 0 the interleaved RGB entry, 1 the planar entry, 2 the YUV entry
// (its chroma bands follow from the luma's); plan[0..3] = the column tile
// in output texels, the tiles of a row, a block's shared-memory bytes and
// its threads.  Returns cudaErrorInvalidValue for an unknown entry or an
// empty output.
extern "C" int vaudio_mip_pool_plan(int entry, int T, int H, int W,
                                    int level, int* plan) {
    if (T <= 0 || level < 0 || (H >> level) <= 0 || (W >> level) <= 0)
        return cudaErrorInvalidValue;
    if (entry == 0)
        write_plan(rgb_launch(T, H, W, level), plan);
    else if (entry == 1)
        write_plan(planes_launch(T, H, W, level), plan);
    else if (entry == 2 && level >= 1)
        write_plan(yuv420_launch(T, H, W, level), plan);
    else
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// y: u8 (T, H, W); u, v: u8 (T, Hc, Wc), all contiguous, with
// Hc >> (level - 1) >= H >> level and Wc >> (level - 1) >= W >> level
// (1 <= level); out: f32 (T, 3, H >> level, W >> level) contiguous.  The
// constants are YuvConsts' in order.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int vaudio_mip_pool_yuv420_u8(
        const void* y, const void* u, const void* v, void* out, int T, int H,
        int W, int Hc, int Wc, int level, float y_gain, float y_offset,
        float y_add, float c_gain, float c_offset, float c_add, float kr,
        float kgu, float kgv, float kb, void* stream) {
    const int hm = H >> level;
    const int wm = W >> level;
    if (T <= 0 || hm <= 0 || wm <= 0) return cudaSuccess;
    if (level < 1 || (Hc >> (level - 1)) < hm || (Wc >> (level - 1)) < wm)
        return cudaErrorInvalidValue;
    if (!grid_fits(hm, T)) return cudaErrorInvalidConfiguration;
    const Launch<3> launch = yuv420_launch(T, H, W, level);
    const cudaError_t err = allow_smem(mip_pool_yuv420_kernel, launch.smem,
                                       yuv420_smem);
    if (err != cudaSuccess) return err;
    const YuvConsts c{y_gain, y_offset, y_add, c_gain, c_offset, c_add,
                      kr, kgu, kgv, kb};
    dim3 grid(launch.tiles, hm, T);
    mip_pool_yuv420_kernel<<<grid, launch.threads, launch.smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), static_cast<float*>(out), H, W, Hc,
        Wc, level, launch.tile, c);
    return static_cast<int>(cudaGetLastError());
}
