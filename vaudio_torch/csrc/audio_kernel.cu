// Kernel K4: the fused AGC + overlap-add audio tail, for T frames of S
// independent streams at once.
//
// Replaces: vaudio/ops/audio_kernel.py, agc_overlap_add (body
// _agc_ola_kernel) — the TPU kernel that runs the whole audio tail of
// frame_step (SoundEngine.swift:412-428,231-254) in one VMEM-resident
// program — and the chunked tail that the JAX package leaves to XLA
// (vaudio/runtime/chunked.py:250-290: the same math, with the running-max
// recurrence as a lax.scan over per-frame peaks).
//
// What it computes, for frames t = 0..T-1 of C = 1 or 2 channels of nfft
// samples (the gains are shared across a frame's channels):
//   m_t   = max|sig_t|,  p_t = m_t + 1e-9
//   rm_t  = p_t > rm_{t-1} ? attack p_t + (1 - attack) rm_{t-1}
//                          : release p_t + (1 - release) rm_{t-1}
//   g_t   = 1 / (1 + exp(-2 (p_t / rm_t - 0.5)))
//   nf_t  = clip((g_t - g0) / (g1 - g0), 0, 1)
//   y_t   = frame order: sig_t / (p_t / nf_t)
//           chunk order: sig_t * s_t,  s_t = 1 / (p_t / nf_t), 0 where
//                        not finite
//           (non-finite values of y_t set to 0)
//   w_t   = (y_t * (1 / (max|y_t| + 1e-6))) * window
//   pcm_t = w_{t-1}[:, hop:] + w_t[:, :hop]   (w_{-1} = the carried tail)
// and returns pcm f32[T, hop, C], the last w (the new tail) and rm_{T-1}.
// The frame order is the TPU kernel's (and frame_step's); the chunk order
// is the JAX chunked tail's.  The two round differently (x / v is not
// x * (1 / v)), so each keeps its own.  Every operation is an explicit _rn
// intrinsic in its reference's order, so that no FMA contraction can change
// it; exp is expf, not __expf.  Each frame's bits depend on nothing but its
// own samples, the previous frame's and the carried running max, so a call
// on T frames equals T chained calls on one.
//
// One reduction a frame, not two: for finite samples and 0 < v <= inf,
// rounding is monotone and sign-symmetric, so max_i |fl(x_i / v)| =
// fl(m / v) and max_i |fl(x_i * s)| = fl(m * s) (s is finite, and
// v >= p >= m, so nothing overflows).  Where m is NaN or inf, or v is NaN,
// every y is 0 or non-finite and so set to 0: max|y| = 0.
//
// What bounds it on the H100: latency.  A chunk of 64 stereo frames of 4096
// samples reads 2 MB and writes 1 MB (~1 us at 3.35 TB/s); one frame reads
// and writes ~C 64 KB (~0.04 us).  What takes the time is the launch, one
// round trip to memory for the peaks, the exchange of the peaks, a serial
// T-step recurrence, the scalar chain (expf and five IEEE divides) and a
// second pass over the samples.
//
// What the design does about it: ONE launch per call, of one thread block
// cluster of 8 CTAs per stream (S clusters; stream s is cluster s, and each
// runs what follows on its own stream's frames, tail and scalars, so slot s
// of a launch equals a launch on stream s alone, bit for bit: the grid axis
// that vmap of the TPU kernel's pallas_call adds) (Hopper's distributed shared memory; 8 is the portable
// cluster size) of 512 threads.  CTA r owns the columns j of its eighth of
// [0, hop) in every frame and channel: the samples j and hop + j, read as
// 16-byte vectors where hop % 4 == 0 and the pointers are aligned.  The
// frames go in blocks of up to kBlockFrames; per block:
//   1. peaks: each warp reduces its (frame, column range) units, every
//      channel's loads of a column in flight together (at T <= 8 several
//      warps split a frame); the window and the carried tail that step 4
//      reads are prefetched into L1 meanwhile;
//   2. each CTA pushes its maximum of every frame into all 8 CTAs' shared
//      memory (DSMEM stores, double-buffered by block) and one cluster.sync
//      makes them visible: no remote read, no second cluster barrier.  The
//      first push waits on a cluster barrier arrived at kernel entry, so
//      every CTA has started before its shared memory is written;
//   3. one thread a frame takes the max over the CTAs and the peak's
//      products; thread 0 runs the serial running-max recurrence (two
//      multiply-adds and a select a frame, the same bits in every CTA); one
//      thread a frame computes its scale and gain;
//   4. apply: the same units write pcm_t from sig_t[:, :hop] and
//      sig_{t-1}[:, hop:] (L1 hits for a few frames), recomputing w_{t-1}'s
//      second half from frame t-1's samples and scalars instead of waiting
//      for another CTA's store; the units of frame T-1 also write the new
//      tail.
// Nothing is written to device memory but pcm, the new tail and the running
// max.  No global round trip sits inside the scalar chain, and no sample
// index is divided: the units loop over channels and column vectors.
// Reciprocals are __frcp_rn, the correctly rounded 1/x of the references.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockFrames = 256;       // frames per pass of the block loop

enum Order { kFrameOrder = 0, kChunkOrder = 1 };

struct Args {
    const float* sig;       // [S, T, C, nfft]
    const float* tail;      // [S, C, nfft]
    const float* window;    // [nfft]
    const float* rmax_in;   // [S]
    const float* attack;    // [S]
    const float* release;   // [S]
    float* pcm;             // [S, T, hop, C]
    float* new_tail;        // [S, C, nfft]
    float* rmax_out;        // [S]
    int T;
    int nfft;
    float g0;
    float g1_minus_g0;
};

// max that propagates NaN, as jnp.max and torch.amax do.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || a > b) ? a : b;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&out)[V]) {
    if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        out[0] = q.x;
        out[1] = q.y;
        out[2] = q.z;
        out[3] = q.w;
    } else {
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] = p[e];
    }
}

__device__ __forceinline__ void prefetch_l1(const float* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&in)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int e = 0; e < N; e += 4)
            *reinterpret_cast<float4*>(p + e) =
                make_float4(in[e], in[e + 1], in[e + 2], in[e + 3]);
    } else {
#pragma unroll
        for (int e = 0; e < N; ++e) p[e] = in[e];
    }
}

// One windowed sample: y = x * s (chunk order) or x / v (frame order),
// non-finite set to 0, then (y * gain) * window.
template <int ORDER>
__device__ __forceinline__ float windowed(float x, float sc, float gain,
                                          float w) {
    float y = ORDER == kChunkOrder ? __fmul_rn(x, sc) : __fdiv_rn(x, sc);
    if (!isfinite(y)) y = 0.0f;
    return __fmul_rn(__fmul_rn(y, gain), w);
}

// The scale (chunk order: s; frame order: v) and gain of a frame from its
// peak m = max|sig| and its running max rm.
template <int ORDER>
__device__ __forceinline__ void frame_scalars(float m, float rm, float g0,
                                              float g1_minus_g0, float* sc,
                                              float* gain) {
    const float p = __fadd_rn(m, 1e-9f);
    const float scaled = __fdiv_rn(p, rm);
    const float e = expf(__fmul_rn(-2.0f, __fsub_rn(scaled, 0.5f)));
    const float g = __frcp_rn(__fadd_rn(1.0f, e));
    float nf = __fdiv_rn(__fsub_rn(g, g0), g1_minus_g0);
    if (nf == nf) nf = fminf(fmaxf(nf, 0.0f), 1.0f);
    const float v = __fdiv_rn(p, nf);
    float peak2;
    if (ORDER == kChunkOrder) {
        float s = __frcp_rn(v);
        if (!isfinite(s)) s = 0.0f;
        *sc = s;
        peak2 = isfinite(m) ? __fmul_rn(m, s) : 0.0f;
    } else {
        *sc = v;
        peak2 = (isfinite(m) && v == v) ? __fdiv_rn(m, v) : 0.0f;
    }
    *gain = __frcp_rn(__fadd_rn(peak2, 1e-6f));
}

template <int V, int C, int ORDER>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
agc_overlap_add_kernel(const Args a) {
    // Every CTA's frame maxima, pushed by their owners; two buffers, so a
    // CTA one block ahead never overwrites what a slower one still reads.
    __shared__ float s_all[2][kCluster][kBlockFrames];
    __shared__ float s_part[kBlockFrames];  // per unit of this CTA
    __shared__ float s_rm[kBlockFrames];    // running max after the frame
    __shared__ float s_sc[kBlockFrames];    // scale (attack * p first)
    __shared__ float s_gain[kBlockFrames];  // gain (release * p first)
    __shared__ float s_carry[3];  // running max; the last frame's sc, gain

    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int nfft = a.nfft, hop = nfft / 2, T = a.T;
    const int rank = static_cast<int>(cluster.block_rank());
    const long long nvec = hop / V;
    const int jv0 = static_cast<int>(nvec * rank / kCluster);
    const int nv = static_cast<int>(nvec * (rank + 1) / kCluster) - jv0;
    const size_t frame = static_cast<size_t>(C) * nfft;
    // This cluster's stream: its frames, tail, pcm and scalars.
    const int st = blockIdx.x / kCluster;
    const size_t st_frames = static_cast<size_t>(st) * T;
    const float* __restrict__ sig = a.sig + st_frames * frame;
    const float* __restrict__ tail = a.tail + st * frame;
    const float* __restrict__ window = a.window;
    float* __restrict__ pcm = a.pcm + st_frames * frame / 2;
    float* __restrict__ new_tail = a.new_tail + st * frame;
    // No CTA may write into another's shared memory before every CTA of
    // the cluster has started: arrive here, wait before the first push
    // (the first block's peaks pass runs in between).
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    if (tid == 0) {
        s_carry[0] = a.rmax_in[st];
        s_carry[1] = s_carry[2] = 0.0f;     // read only after a first block
    }
    const float attack = a.attack[st], release = a.release[st];

    for (int t0 = 0, buf = 0; t0 < T; t0 += kBlockFrames, buf ^= 1) {
        const int tb = min(kBlockFrames, T - t0);
        // S warps share a frame's columns while warps outnumber frames.
        const int S = max(1, min(kWarps / tb, (nv + 31) / 32));
        const int units = tb * S;

        // 1. peaks of this CTA's columns, one per unit; every channel's
        //    loads of a column vector in flight together.
        for (int u = warp; u < units; u += kWarps) {
            const int tl = u / S, s = u - tl * S;
            const int lo = jv0 + nv * s / S, hi = jv0 + nv * (s + 1) / S;
            const float* f = sig + (t0 + tl) * frame;
            float m = 0.0f;
#pragma unroll 2
            for (int jv = lo + lane; jv < hi; jv += 32) {
                float x0[C][V], x1[C][V];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    load<V>(f + c * nfft + jv * V, x0[c]);
                    load<V>(f + c * nfft + hop + jv * V, x1[c]);
                }
                // what pass 4 reads besides the samples, on its way to L1
                prefetch_l1(window + jv * V);
                prefetch_l1(window + hop + jv * V);
                if (t0 + tl == 0)
#pragma unroll
                    for (int c = 0; c < C; ++c)
                        prefetch_l1(tail + c * nfft + hop + jv * V);
#pragma unroll
                for (int c = 0; c < C; ++c)
#pragma unroll
                    for (int e = 0; e < V; ++e)
                        m = max_nan(max_nan(m, fabsf(x0[c][e])),
                                    fabsf(x1[c][e]));
            }
            for (int o = 16; o > 0; o >>= 1)
                m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
            if (lane == 0) s_part[u] = m;
        }
        __syncthreads();

        // 2. push this CTA's maximum of each frame into every CTA's shared
        //    memory (DSMEM); after one cluster.sync each CTA reads its own.
        if (t0 == 0)
            asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
        for (int tl = tid; tl < tb; tl += kThreads) {
            float m = s_part[tl * S];
            for (int s = 1; s < S; ++s) m = max_nan(m, s_part[tl * S + s]);
#pragma unroll
            for (int q = 0; q < kCluster; ++q)
                *cluster.map_shared_rank(&s_all[buf][rank][tl], q) = m;
        }
        cluster.sync();

        // 3. each frame's max over the cluster and the products of its
        //    peak (one thread a frame), then the running max (serial, the
        //    same bits in every CTA), then each frame's scalars.
        for (int tl = tid; tl < tb; tl += kThreads) {
            float m = s_all[buf][0][tl];
#pragma unroll
            for (int q = 1; q < kCluster; ++q)
                m = max_nan(m, s_all[buf][q][tl]);
            const float p = __fadd_rn(m, 1e-9f);
            s_part[tl] = m;
            s_sc[tl] = __fmul_rn(attack, p);
            s_gain[tl] = __fmul_rn(release, p);
        }
        __syncthreads();
        if (tid == 0) {
            const float keep_a = __fsub_rn(1.0f, attack);
            const float keep_r = __fsub_rn(1.0f, release);
            float rm = s_carry[0];
#pragma unroll 4
            for (int tl = 0; tl < tb; ++tl) {
                const float p = __fadd_rn(s_part[tl], 1e-9f);
                const float attacked = __fadd_rn(s_sc[tl],
                                                 __fmul_rn(keep_a, rm));
                const float released = __fadd_rn(s_gain[tl],
                                                 __fmul_rn(keep_r, rm));
                rm = p > rm ? attacked : released;
                s_rm[tl] = rm;
            }
            s_carry[0] = rm;
        }
        __syncthreads();
        for (int tl = tid; tl < tb; tl += kThreads)
            frame_scalars<ORDER>(s_part[tl], s_rm[tl], a.g0, a.g1_minus_g0,
                                 &s_sc[tl], &s_gain[tl]);
        __syncthreads();

        // 4. apply: pcm of each frame, and the new tail from frame T-1.
        for (int u = warp; u < units; u += kWarps) {
            const int tl = u / S, s = u - tl * S;
            const int t = t0 + tl;
            const int lo = jv0 + nv * s / S, hi = jv0 + nv * (s + 1) / S;
            const float sc = s_sc[tl], gain = s_gain[tl];
            const float prev_sc = tl ? s_sc[tl - 1] : s_carry[1];
            const float prev_gain = tl ? s_gain[tl - 1] : s_carry[2];
            const float* f = sig + t * frame;
            // frame t-1's second half, or the carried tail at t = 0
            const float* g = t ? f - frame + hop : tail + hop;
            const bool last = t == T - 1;
#pragma unroll 2
            for (int jv = lo + lane; jv < hi; jv += 32) {
                const int j = jv * V;
                float wa[V], wb[V], x[C][V], prev[C][V], x1[C][V];
                float out[V * C];
                load<V>(window + j, wa);
                load<V>(window + hop + j, wb);
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    load<V>(f + c * nfft + j, x[c]);
                    load<V>(g + c * nfft + j, prev[c]);
                    if (last) load<V>(f + c * nfft + hop + j, x1[c]);
                }
#pragma unroll
                for (int c = 0; c < C; ++c) {
#pragma unroll
                    for (int e = 0; e < V; ++e) {
                        const float w = windowed<ORDER>(x[c][e], sc, gain,
                                                        wa[e]);
                        const float pw = t ? windowed<ORDER>(
                            prev[c][e], prev_sc, prev_gain, wb[e])
                            : prev[c][e];
                        out[e * C + c] = __fadd_rn(pw, w);
                        x[c][e] = w;
                    }
                    if (last) {
#pragma unroll
                        for (int e = 0; e < V; ++e)
                            x1[c][e] = windowed<ORDER>(x1[c][e], sc, gain,
                                                       wb[e]);
                        store<V>(new_tail + c * nfft + j, x[c]);
                        store<V>(new_tail + c * nfft + hop + j, x1[c]);
                    }
                }
                store<V * C>(pcm + (static_cast<size_t>(t) * hop + j) * C,
                             out);
            }
        }
        __syncthreads();
        if (tid == 0) {
            s_carry[1] = s_sc[tb - 1];
            s_carry[2] = s_gain[tb - 1];
        }
        __syncthreads();
    }
    if (rank == 0 && tid == 0) a.rmax_out[st] = s_carry[0];
}

template <int V, int C>
void launch(const Args& a, int S, int order, cudaStream_t stream) {
    if (order == kChunkOrder)
        agc_overlap_add_kernel<V, C, kChunkOrder>
            <<<kCluster * S, kThreads, 0, stream>>>(a);
    else
        agc_overlap_add_kernel<V, C, kFrameOrder>
            <<<kCluster * S, kThreads, 0, stream>>>(a);
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// S streams: sig f32[S, T, C, nfft]; tail f32[S, C, nfft]; window
// f32[nfft]; rmax, attack, release f32[S]; pcm f32[S, T, nfft / 2, C];
// new_tail f32[S, C, nfft]; new_rmax f32[S]; all on the device and
// contiguous; S >= 1, T >= 1, C = 1 or 2, nfft even.  order 0 is the frame
// order (the TPU kernel's), 1 the chunk order (the JAX chunked tail's); g0
// and g1_minus_g0 are the f32 sigmoid bounds.  One launch of S clusters on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int vaudio_agc_overlap_add(
        const void* sig, const void* tail, const void* window,
        const void* rmax, const void* attack, const void* release, void* pcm,
        void* new_tail, void* new_rmax, int S, int T, int C, int nfft,
        int order, float g0, float g1_minus_g0, void* stream) {
    if (S < 1 || T < 1 || (C != 1 && C != 2) || nfft < 2 || nfft % 2 != 0
            || (order != kFrameOrder && order != kChunkOrder))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const float*>(sig),
                 static_cast<const float*>(tail),
                 static_cast<const float*>(window),
                 static_cast<const float*>(rmax),
                 static_cast<const float*>(attack),
                 static_cast<const float*>(release),
                 static_cast<float*>(pcm),
                 static_cast<float*>(new_tail),
                 static_cast<float*>(new_rmax),
                 T, nfft, g0, g1_minus_g0};
    const bool vec = (nfft / 2) % 4 == 0 && aligned16(sig) && aligned16(tail)
        && aligned16(window) && aligned16(pcm) && aligned16(new_tail);
    const auto s = static_cast<cudaStream_t>(stream);
    if (vec)
        C == 1 ? launch<4, 1>(a, S, order, s) : launch<4, 2>(a, S, order, s);
    else
        C == 1 ? launch<1, 1>(a, S, order, s) : launch<1, 2>(a, S, order, s);
    return static_cast<int>(cudaGetLastError());
}
