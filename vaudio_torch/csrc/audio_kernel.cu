// Kernel K4: the fused AGC + overlap-add audio tail of the per-frame step.
//
// Replaces: vaudio/ops/audio_kernel.py, agc_overlap_add (body
// _agc_ola_kernel) — the TPU kernel that runs the whole audio tail of
// frame_step (SoundEngine.swift:412-428,231-254) in one VMEM-resident
// program.
//
// What it computes, for one frame of C = 1 or 2 channels of nfft samples
// (the gains are shared across the channels, so the stereo image holds):
//   frame_peak = max|sig| + 1e-9
//   new_max    = frame_peak > rmax ? attack  frame_peak + (1 - attack)  rmax
//                                  : release frame_peak + (1 - release) rmax
//   g          = 1 / (1 + exp(-2 (frame_peak / new_max - 0.5)))
//   norm       = clip((g - g0) / (g1 - g0), 0, 1)    (g0, g1, g1 - g0 in f32)
//   x          = sig / (frame_peak / norm), non-finite values set to 0
//   windowed   = (x * (1 / (max|x| + 1e-6))) * window
//   pcm        = tail[:, hop:] + windowed[:, :hop];  new tail = windowed
// Every operation is an explicit _rn intrinsic in the TPU kernel's order,
// so that no FMA contraction can change it; exp is expf, not __expf.
//
// What bounds it on the H100: launch latency.  It reads and writes ~C 64 KB
// (~0.04 us at 3.35 TB/s), far less than the few microseconds a launch
// costs, and it is a chain of two dependent reductions.
//
// What the design does about it: everything happens in one launch of one
// block of 1024 threads.  Each thread keeps its (at most 8) samples in
// registers; two block max-reductions (warp shuffles, then one warp over
// the warp maxima) with one thread computing the scalars between them,
// then one elementwise pass writes the new tail and the PCM.  The running
// max, attack and release stay device scalars: the host never waits.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;           // C * nfft <= 8192

// max that propagates NaN, as jnp.max and torch.amax do.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || a > b) ? a : b;
}

// Block-wide max of one value per thread; every thread gets the result.
__device__ float block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1)
        v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = red[lane];
        for (int o = 16; o > 0; o >>= 1)
            v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane == 0) red[kWarps] = v;
    }
    __syncthreads();
    const float out = red[kWarps];
    __syncthreads();                    // red is reused by the next call
    return out;
}

__global__ void __launch_bounds__(kThreads) agc_overlap_add_kernel(
        const float* __restrict__ sig, const float* __restrict__ tail,
        const float* __restrict__ window, const float* __restrict__ rmax_in,
        const float* __restrict__ attack_in,
        const float* __restrict__ release_in, float* __restrict__ pcm,
        float* __restrict__ new_tail, float* __restrict__ rmax_out, int C,
        int nfft, float g0, float g1_minus_g0) {
    __shared__ float red[kWarps + 1];
    __shared__ float s_norm_value;
    const int n = C * nfft;
    float x[kPerThread];
    float peak = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        x[k] = i < n ? sig[i] : 0.0f;
        peak = max_nan(peak, fabsf(x[k]));
    }
    peak = block_max(peak, red);

    if (threadIdx.x == 0) {
        const float fp = __fadd_rn(peak, 1e-9f);
        const float rmax = *rmax_in;
        const float attack = *attack_in;
        const float release = *release_in;
        const float attacked = __fadd_rn(
            __fmul_rn(attack, fp), __fmul_rn(__fsub_rn(1.0f, attack), rmax));
        const float released = __fadd_rn(
            __fmul_rn(release, fp),
            __fmul_rn(__fsub_rn(1.0f, release), rmax));
        const float new_max = fp > rmax ? attacked : released;
        const float scaled = __fdiv_rn(fp, new_max);
        const float e = expf(__fmul_rn(-2.0f, __fsub_rn(scaled, 0.5f)));
        const float g = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
        float norm = __fdiv_rn(__fsub_rn(g, g0), g1_minus_g0);
        if (norm == norm) norm = fminf(fmaxf(norm, 0.0f), 1.0f);
        s_norm_value = __fdiv_rn(fp, norm);
        *rmax_out = new_max;
    }
    __syncthreads();

    const float norm_value = s_norm_value;
    float peak2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n) {
            float v = __fdiv_rn(x[k], norm_value);
            if (!isfinite(v)) v = 0.0f;
            x[k] = v;
            peak2 = max_nan(peak2, fabsf(v));
        }
    }
    peak2 = block_max(peak2, red);
    const float gain = __fdiv_rn(1.0f, __fadd_rn(peak2, 1e-6f));

    const int hop = nfft / 2;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < n) {
            const int c = i / nfft;
            const int j = i - c * nfft;
            const float w = __fmul_rn(__fmul_rn(x[k], gain), window[j]);
            new_tail[i] = w;
            if (j < hop) pcm[c * hop + j] = __fadd_rn(tail[i + hop], w);
        }
    }
}

}  // namespace

// sig, tail f32[C, nfft]; window f32[nfft]; rmax, attack, release f32[1];
// pcm f32[C, nfft / 2]; new_tail f32[C, nfft]; new_rmax f32[1]; all on the
// device and contiguous, C * nfft <= 8192, nfft even.  g0 and g1_minus_g0
// are the f32 sigmoid bounds.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a size it does not take).
extern "C" int vaudio_agc_overlap_add(
        const void* sig, const void* tail, const void* window,
        const void* rmax, const void* attack, const void* release, void* pcm,
        void* new_tail, void* new_rmax, int C, int nfft, float g0,
        float g1_minus_g0, void* stream) {
    if (C <= 0 || nfft <= 0 || nfft % 2 != 0
            || C * nfft > kThreads * kPerThread)
        return static_cast<int>(cudaErrorInvalidValue);
    agc_overlap_add_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sig), static_cast<const float*>(tail),
        static_cast<const float*>(window), static_cast<const float*>(rmax),
        static_cast<const float*>(attack), static_cast<const float*>(release),
        static_cast<float*>(pcm), static_cast<float*>(new_tail),
        static_cast<float*>(new_rmax), C, nfft, g0, g1_minus_g0);
    return static_cast<int>(cudaGetLastError());
}
