// Kernel K2: the batched Hann-peak spectrum contraction.
//
// Replaces: vaudio/ops/spectrum_kernel.py, hann_peak_weighted_sum_batched
// (body _spectrum_kernel_batched) and, at T = 1, hann_peak_weighted_sum
// (body _spectrum_kernel) — the TPU kernels that evaluate the (partials x
// bins) peak matrix on the VPU and contract it on the MXU.
//
// What it computes:
//   out[t, f, k] = sum_p W((freqs[f] - pf[t, p]) * scale[t, p]) * w[t, p, k]
// where W is vaudio.dsp.core.hann_sinc_peak_fast: n = rint(d) (half to
// even), a 5-term odd polynomial for sin(pi (d - n)), the sign (-1)^n, and
// one divide by the factored denominator pi d (d - 1) (d + 1), with the
// exact limits 0.5 at d = 0 and -0.25 at |d| = 1.  W is evaluated with
// explicit _rn intrinsics in the JAX op order, so that FMA contraction
// cannot change it: each W equals the plain PyTorch version's bit for bit,
// and only the order of the sum over partials differs.
//
// What bounds it on the H100: arithmetic.  At F = 2047 and NP = 496 a frame
// is 1.0M peak evaluations of ~25 f32 operations and a divide each, against
// 12 KB of operands; K = 2 or 4 output columns is far too narrow for the
// tensor cores, so the contraction is CUDA-core f32 work.
//
// What the design does about it: one block per (frame, tile of 256 bins);
// the frame's pf, scale and w (NP <= 1024, K <= 4) are staged once in
// shared memory, and every thread owns one bin, loops over the partials
// from shared memory (a broadcast read) and keeps its K sums in registers.
// Nothing but the (T, F, K) result is written to device memory.  No padding
// of the partials is needed: NP is a loop bound.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kA1 = 3.1415925f;
constexpr float kA3 = -5.167707f;
constexpr float kA5 = 2.5500314f;
constexpr float kA7 = -0.5980451f;
constexpr float kA9 = 0.07722007f;

__device__ __forceinline__ float hann_sinc_peak_fast(float d) {
    const float n = rintf(d);
    const float frac = __fsub_rn(d, n);
    const float x2 = __fmul_rn(frac, frac);
    float p = __fadd_rn(__fmul_rn(x2, kA9), kA7);
    p = __fadd_rn(__fmul_rn(p, x2), kA5);
    p = __fadd_rn(__fmul_rn(p, x2), kA3);
    p = __fadd_rn(__fmul_rn(p, x2), kA1);
    float s = __fmul_rn(frac, p);
    if (fmodf(n, 2.0f) != 0.0f) s = -s;                 // (-1)^n
    const float num = __fsub_rn(__fmul_rn(d, d), 0.5f);
    const float den = __fmul_rn(
        __fmul_rn(__fmul_rn(kPi, d), __fsub_rn(d, 1.0f)),
        __fadd_rn(d, 1.0f));
    float w = __fmul_rn(s, __fdiv_rn(num, den));
    if (d == 0.0f) w = 0.5f;
    if (fabsf(d) == 1.0f) w = -0.25f;
    return w;
}

template <int K>
__global__ void hann_peak_weighted_sum_kernel(
        const float* __restrict__ freqs, const float* __restrict__ pf,
        const float* __restrict__ scale, const float* __restrict__ w,
        float* __restrict__ out, int F, int NP) {
    extern __shared__ float smem[];
    float* s_pf = smem;
    float* s_scale = smem + NP;
    float* s_w = smem + 2 * NP;
    const int t = blockIdx.y;
    const float* pf_t = pf + static_cast<size_t>(t) * NP;
    const float* scale_t = scale + static_cast<size_t>(t) * NP;
    const float* w_t = w + static_cast<size_t>(t) * NP * K;
    for (int i = threadIdx.x; i < NP; i += kThreads) {
        s_pf[i] = pf_t[i];
        s_scale[i] = scale_t[i];
    }
    for (int i = threadIdx.x; i < NP * K; i += kThreads) s_w[i] = w_t[i];
    __syncthreads();

    const int f = blockIdx.x * kThreads + threadIdx.x;
    if (f >= F) return;
    const float freq = freqs[f];
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    for (int p = 0; p < NP; ++p) {
        const float d = __fmul_rn(__fsub_rn(freq, s_pf[p]), s_scale[p]);
        const float peak = hann_sinc_peak_fast(d);
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(peak, s_w[p * K + k], acc[k]);
    }
    float* dst = out + (static_cast<size_t>(t) * F + f) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = acc[k];
}

}  // namespace

// freqs f32[F]; pf, scale f32[T, NP]; w f32[T, NP, K]; out f32[T, F, K]; all
// contiguous, K in {2, 4}, NP <= 1024.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported K).
extern "C" int vaudio_hann_peak_weighted_sum(
        const void* freqs, const void* pf, const void* scale, const void* w,
        void* out, int T, int F, int NP, int K, void* stream) {
    if (T <= 0 || F <= 0) return cudaSuccess;
    const dim3 grid((F + kThreads - 1) / kThreads, T);
    const size_t smem = static_cast<size_t>(NP) * (2 + K) * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* fr = static_cast<const float*>(freqs);
    const float* p = static_cast<const float*>(pf);
    const float* sc = static_cast<const float*>(scale);
    const float* wt = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    if (K == 2) {
        hann_peak_weighted_sum_kernel<2><<<grid, kThreads, smem, s>>>(
            fr, p, sc, wt, o, F, NP);
    } else if (K == 4) {
        hann_peak_weighted_sum_kernel<4><<<grid, kThreads, smem, s>>>(
            fr, p, sc, wt, o, F, NP);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
