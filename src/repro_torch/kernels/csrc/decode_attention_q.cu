// One-token GQA decode attention over an int8 KV slot pool (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention_q.py
// (decode_attention_q, pl.pallas_call at :126).  There the grid is
// (B, KH, S/bs) with the sequence axis innermost and in order, the
// online-softmax state carried across it in VMEM scratch.  GPU blocks
// run in no order, so here one CTA owns one (slot, KV head) pair and
// walks the sequence itself, the running max / sum / accumulator in
// shared memory and registers.
//
// Math, as the TPU kernel does it (decode_attention_q.py:70-98):
//   * K scales and 1/sqrt(D) fold into the query rows in f32:
//     s = (q * (k_scale * 1/sqrt(D))) . k_q;
//   * softcap (if nonzero) applies to the logits before the mask;
//   * positions > cache_pos[slot] are masked with -1e30 (not -inf): a slot
//     with no valid position gets the finite uniform average the plain
//     version gives, not NaN.  Positions past S do not exist here (no
//     padding) and weigh exactly 0;
//   * the output is acc / l * v_scale, cast to q's type.
// The G = H/KH query heads of the group ride as rows, so one pass over a
// K/V block serves the whole group.
//
// What bounds it on an H100: the pool bytes, 2*S*D int8 per (slot, head)
// -- a handful of FLOPs per byte.  Every position is read (masked, not
// skipped), as in the reference.  Simple first: B*KH CTAs of 128 threads
// (64 for the served model on 132 SMs), K/V blocks of 64 positions staged
// through shared memory with 16-byte loads (rows padded by one word so
// the per-position dot products hit distinct banks), plain f32 FMAs.
// Splitting S across CTAs, and skipping blocks past cache_pos, are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace daq {

constexpr int THREADS = 128;
constexpr int BS = 64;                   // positions per staged block
constexpr int MAX_D = 256;
constexpr int MAX_G = 16;
constexpr int MAX_OUT = 8;               // (g, d) outputs per thread
constexpr int WPAD = MAX_D / 4 + 1;      // words per staged row
constexpr float NEG = -1e30f;            // the reference's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Signed byte j (0..3) of a packed word, as float.
__device__ __forceinline__ float byte_f32(int word, int j) {
  return (float)((int)((unsigned)word << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q (B,KH,G,D) T; kq/vq (B,S,KH,D) int8; ks/vs (B,KH,D) f32;
// cache_pos (B,) int32; out (B,KH,G,D) T.  Grid (KH, B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_q_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ ks,
                     const int8_t* __restrict__ vq,
                     const float* __restrict__ vs,
                     const int* __restrict__ cache_pos, T* __restrict__ out,
                     int S, int KH, int G, int D, float scale,
                     float softcap) {
  __shared__ float Qs[THREADS * MAX_OUT];        // folded query rows
  __shared__ int Ks[BS * WPAD];
  __shared__ int Vs[BS * WPAD];
  __shared__ float Ps[MAX_G * BS];               // logits, then weights
  __shared__ float m_s[MAX_G], l_s[MAX_G], a_s[MAX_G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int W = D / 4, chunks = D / 16, n_out = G * D;
  const int cp = cache_pos[b];
  const size_t pos_stride = (size_t)KH * D;      // bytes between positions
  const size_t head = (size_t)b * KH + h;
  const int8_t* kb = kq + ((size_t)b * S * KH + h) * D;
  const int8_t* vb = vq + ((size_t)b * S * KH + h) * D;
  const float* ksb = ks + head * D;
  const float* vsb = vs + head * D;
  const T* qb = q + head * G * D;

  for (int i = tid; i < n_out; i += THREADS)
    Qs[i] = to_f32(qb[i]) * (ksb[i % D] * scale);
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int k = 0; k < MAX_OUT; ++k) acc[k] = 0.f;

  for (int s0 = 0; s0 < S; s0 += BS) {
    const int npos = min(BS, S - s0);
    for (int e = tid; e < npos * chunks; e += THREADS) {
      const int p = e / chunks, c = e % chunks;
      const size_t off = (size_t)(s0 + p) * pos_stride + c * 16;
      const int4 kv = *reinterpret_cast<const int4*>(kb + off);
      const int4 vv = *reinterpret_cast<const int4*>(vb + off);
      int* kr = Ks + p * WPAD + c * 4;
      int* vr = Vs + p * WPAD + c * 4;
      kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
      vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
    }
    __syncthreads();

    // Logits of this block; -inf marks a position past S (weight 0).
    for (int e = tid; e < G * BS; e += THREADS) {
      const int g = e / BS, p = e % BS;
      float s = -INFINITY;
      if (p < npos) {
        const int* kr = Ks + p * WPAD;
        const float* qr = Qs + g * D;
        float dot = 0.f;
        for (int w = 0; w < W; ++w) {
          const int word = kr[w];
#pragma unroll
          for (int j = 0; j < 4; ++j) dot += qr[4 * w + j] * byte_f32(word, j);
        }
        if (softcap != 0.f) dot = tanhf(dot / softcap) * softcap;
        s = (s0 + p <= cp) ? dot : NEG;
      }
      Ps[e] = s;
    }
    __syncthreads();

    // Online softmax, one warp per query row.
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = -INFINITY;
      for (int p = lane; p < BS; p += 32) mx = fmaxf(mx, Ps[g * BS + p]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < BS; p += 32) {
        const float sv = Ps[g * BS + p];
        const float w = sv == -INFINITY ? 0.f : expf(sv - m_new);
        Ps[g * BS + p] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k) {
      const int o = tid + k * THREADS;
      if (o < n_out) {
        const int g = o / D, d = o % D;
        const float* pr = Ps + g * BS;
        const int* vc = Vs + (d >> 2);
        float a = acc[k] * a_s[g];
        for (int p = 0; p < npos; ++p)
          a += pr[p] * byte_f32(vc[p * WPAD], d & 3);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + head * G * D;
#pragma unroll
  for (int k = 0; k < MAX_OUT; ++k) {
    const int o = tid + k * THREADS;
    if (o < n_out)
      ob[o] = from_f32<T>(acc[k] / l_s[o / D] * vsb[o % D]);
  }
}

template <typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* cache_pos, void* out, int B, int S,
           int KH, int G, int D, float softcap, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  decode_attn_q_kernel<T><<<dim3(KH, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(cache_pos),
      static_cast<T*>(out), S, KH, G, D, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace daq

extern "C" {

// Whether the kernel takes this geometry: D a multiple of 16 up to 256,
// at most 16 query heads per KV head, G*D <= 1024, S >= 1.
int lrk_decode_attention_q_fits(int S, int G, int D) {
  return S >= 1 && D >= 16 && D % 16 == 0 && D <= daq::MAX_D && G >= 1 &&
         G <= daq::MAX_G && G * D <= daq::THREADS * daq::MAX_OUT;
}

// out (B,KH,G,D) = attention of q (B,KH,G,D) over the int8 pool kq/vq
// (B,S,KH,D) with scales ks/vs (B,KH,D) f32 and positions <= cache_pos (B,)
// int32; all contiguous.  dtype: 0 = float32, 1 = bfloat16 (q, out).
// Returns the launch's cudaError_t (0 on success).
int lrk_decode_attention_q(int dtype, const void* q, const void* kq,
                           const void* ks, const void* vq, const void* vs,
                           const void* cache_pos, void* out, int B, int S,
                           int KH, int G, int D, float softcap,
                           void* stream) {
  if (!lrk_decode_attention_q_fits(S, G, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return daq::launch<float>(q, kq, ks, vq, vs, cache_pos, out, B, S, KH, G,
                              D, softcap, s);
  if (dtype == 1)
    return daq::launch<__nv_bfloat16>(q, kq, ks, vq, vs, cache_pos, out, B,
                                      S, KH, G, D, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
