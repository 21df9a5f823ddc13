// Kernel K2: the batched Hann-peak spectrum contraction (K2' is the same
// kernel at T = 1).
//
// Replaces: vaudio/ops/spectrum_kernel.py, hann_peak_weighted_sum_batched
// (body _spectrum_kernel_batched) and, at T = 1, hann_peak_weighted_sum
// (body _spectrum_kernel) — the TPU kernels that evaluate the (partials x
// bins) peak matrix on the VPU and contract it on the MXU.
//
// What it computes:
//   out[t, f, k] = sum_p W((freqs[f] - pf[t, p]) * scale[t, p]) * w[t, p, k]
// where W is vaudio_torch.dsp.core.hann_sinc_peak_fast: n = rint(d) (half
// to even), a 5-term odd polynomial for sin(pi (d - n)), the sign (-1)^n,
// and one divide by the factored denominator pi d (d - 1) (d + 1), with the
// exact limits 0.5 at d = 0 and -0.25 at |d| = 1.  W is evaluated with
// explicit _rn intrinsics in the JAX op order and the IEEE divide, so that
// FMA contraction cannot change it: each W equals the plain PyTorch
// version's bit for bit, and only the order of the sum over partials
// differs.
//
// What bounds it on the H100: instruction throughput.  A frame is F x NP =
// 1.0M peak evaluations (F = 2047, NP = 496) against 12 KB of operands.  W alone
// is 19 separately rounded f32 operations, the rint and the IEEE divide
// (reciprocal, refinement, range check); with the distance, the parity,
// the K multiply-adds, the operand loads and the loop, the inner loop is
// ~50 SASS instructions per peak (116 in the first draft, whose fmodf
// parity test was a library routine; counted by vaudio_torch/ops/sass.py).
// No tensor cores: the output is only K = 2 or 4 columns wide, TF32 is off
// (f32 throughout), and the cost is the evaluation of W, not the K
// multiply-adds.  At small T the first draft (one block of 256 bins per
// frame, one thread walking all partials) filled 8 of 132 SMs.
//
// What the design does about it:
//   * the parity of n from the rounded integer, the low bit of
//     __float2int_rn(d) (round half to even, as rintf), not fmodf; floats
//     of magnitude 2^24 and above are all even (and the conversion
//     saturates from 2^31), so |d| is clamped to 2^24 first.  The sign is
//     applied to W's sign bit, and the two limits are one select where the
//     denominator is 0;
//   * a block owns 32 bins (one per lane) and splits the partials over its
//     16 warps: warp w sums the partials p = w mod 16 in order, and the 16
//     sums of each bin are added in warp order in shared memory.  The grid
//     is (ceil(F / 32), T): 64 blocks at T = 1, 4096 at T = 64.  Nothing
//     depends on T and no float atomic is used, so each frame's output is
//     the same bits at any T and from run to run;
//   * the frame's operands are packed in shared memory, (pf, scale) as one
//     float2 and the K weights as one float4 (K = 4) or float2 (K = 2): each
//     partial is two broadcast loads per warp.
// Nothing but the (T, F, K) result is written to device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 32;                 // bins per block, one per lane
constexpr int kWarps = 16;                // partials split over the warps
constexpr int kThreads = kBins * kWarps;  // 512

constexpr float kPi = 3.14159265358979323846f;
constexpr float kA1 = 3.1415925f;
constexpr float kA3 = -5.167707f;
constexpr float kA5 = 2.5500314f;
constexpr float kA7 = -0.5980451f;
constexpr float kA9 = 0.07722007f;
constexpr float kTwo24 = 16777216.0f;

__device__ __forceinline__ float hann_sinc_peak_fast(float d) {
    const float n = rintf(d);
    const float frac = __fsub_rn(d, n);
    const float x2 = __fmul_rn(frac, frac);
    float p = __fadd_rn(__fmul_rn(x2, kA9), kA7);
    p = __fadd_rn(__fmul_rn(p, x2), kA5);
    p = __fadd_rn(__fmul_rn(p, x2), kA3);
    p = __fadd_rn(__fmul_rn(p, x2), kA1);
    const float s = __fmul_rn(frac, p);
    const float num = __fsub_rn(__fmul_rn(d, d), 0.5f);
    const float den = __fmul_rn(
        __fmul_rn(__fmul_rn(kPi, d), __fsub_rn(d, 1.0f)),
        __fadd_rn(d, 1.0f));
    float w = __fmul_rn(s, __fdiv_rn(num, den));
    // The sign (-1)^n of s, applied to w: (-s) q = -(s q) when rounding to
    // nearest.  The parity is the low bit of the rounded integer; floats of
    // magnitude 2^24 and above are even, so |d| is clamped there first.
    const unsigned odd = __float2int_rn(fminf(fabsf(d), kTwo24));
    w = __uint_as_float(__float_as_uint(w) ^ (odd << 31));
    // den is 0 at d = 0 and |d| = 1 exactly (no other product of its
    // factors rounds to 0): the limits 0.5 and -0.25, 0.5 - 0.75 |d|.
    if (den == 0.0f) w = __fmaf_rn(-0.75f, fabsf(d), 0.5f);
    return w;
}

template <int K> struct Weights;
template <> struct Weights<2> { using type = float2; };
template <> struct Weights<4> { using type = float4; };

__device__ __forceinline__ void unpack(const float2& v, float* x) {
    x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void unpack(const float4& v, float* x) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <int K>
__global__ void __launch_bounds__(kThreads) hann_peak_weighted_sum_kernel(
        const float* __restrict__ freqs, const float* __restrict__ pf,
        const float* __restrict__ scale, const float* __restrict__ w,
        float* __restrict__ out, int F, int NP) {
    using Vec = typename Weights<K>::type;
    extern __shared__ float4 smem[];                 // 16-byte aligned
    Vec* s_w = reinterpret_cast<Vec*>(smem);                     // [NP]
    float2* s_ps = reinterpret_cast<float2*>(s_w + NP);          // [NP]
    float* s_part = reinterpret_cast<float*>(s_ps + NP);  // [kWarps][kBins][K]
    const int t = blockIdx.y;
    const float* pf_t = pf + static_cast<size_t>(t) * NP;
    const float* scale_t = scale + static_cast<size_t>(t) * NP;
    const float* w_t = w + static_cast<size_t>(t) * NP * K;
    for (int i = threadIdx.x; i < NP; i += kThreads) {
        s_ps[i] = make_float2(pf_t[i], scale_t[i]);
        float x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = w_t[i * K + k];
        if constexpr (K == 2) s_w[i] = make_float2(x[0], x[1]);
        else s_w[i] = make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int f0 = blockIdx.x * kBins;
    const float freq = freqs[min(f0 + lane, F - 1)];  // the ragged tile's
    float acc[K];                                     // extra lanes repeat
#pragma unroll                                        // the last bin
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int p = warp; p < NP; p += kWarps) {
        const float2 ps = s_ps[p];
        const float d = __fmul_rn(__fsub_rn(freq, ps.x), ps.y);
        const float peak = hann_sinc_peak_fast(d);
        float wk[K];
        unpack(s_w[p], wk);
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(peak, wk[k], acc[k]);
    }
    float* part = s_part + (warp * kBins + lane) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = acc[k];
    __syncthreads();

    // The 16 warp sums of each (bin, column), added in warp order.
    if (threadIdx.x < kBins * K) {
        const int b = threadIdx.x / K;
        float sum = s_part[threadIdx.x];
#pragma unroll
        for (int v = 1; v < kWarps; ++v)
            sum = __fadd_rn(sum, s_part[v * kBins * K + threadIdx.x]);
        if (f0 + b < F)
            out[(static_cast<size_t>(t) * F + f0) * K + threadIdx.x] = sum;
    }
}

template <int K>
void launch(const float* fr, const float* p, const float* sc,
            const float* wt, float* o, int T, int F, int NP,
            cudaStream_t s) {
    const dim3 grid((F + kBins - 1) / kBins, T);
    const size_t smem = static_cast<size_t>(NP) * (K + 2) * sizeof(float)
                        + static_cast<size_t>(kWarps) * kBins * K
                          * sizeof(float);
    hann_peak_weighted_sum_kernel<K><<<grid, kThreads, smem, s>>>(
        fr, p, sc, wt, o, F, NP);
}

}  // namespace

// freqs f32[F]; pf, scale f32[T, NP]; w f32[T, NP, K]; out f32[T, F, K]; all
// contiguous, K in {2, 4}, NP <= 1024 (<= 32 KB of shared memory).
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported K or NP).
extern "C" int vaudio_hann_peak_weighted_sum(
        const void* freqs, const void* pf, const void* scale, const void* w,
        void* out, int T, int F, int NP, int K, void* stream) {
    if (T <= 0 || F <= 0) return cudaSuccess;
    if (NP < 0 || NP > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* fr = static_cast<const float*>(freqs);
    const float* p = static_cast<const float*>(pf);
    const float* sc = static_cast<const float*>(scale);
    const float* wt = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    if (K == 2) {
        launch<2>(fr, p, sc, wt, o, T, F, NP, s);
    } else if (K == 4) {
        launch<4>(fr, p, sc, wt, o, T, F, NP, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
