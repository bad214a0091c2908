// Absorbed-form MLA decode attention over an int8 latent slot pool
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention_q.py
// (decode_attention_latent_q, pl.pallas_call at :241, body _latent_kernel
// at :164).  There the grid is (B, S/bs): all H heads of a slot ride as
// the rows of one block, and the f32 context accumulator (H, L) and the
// online-softmax state are carried across the in-order sequence axis in
// VMEM scratch.  At H = 128 heads of L = 512 latent channels that
// accumulator alone is 256 KiB, over the 227 KB a Hopper block can hold,
// and GPU blocks run in no order.  So here one CTA owns one (head group,
// slot) pair: HG heads (4 at the served shape) walk the slot's latent
// stream themselves, their folded query rows and the running max / sum in
// shared memory, the context accumulator in registers.  Every head group
// re-reads its slot's latents; after the first group they come from L2.
//
// Math, as the TPU kernel does it (decode_attention_q.py:180-208):
//   * the ckv / krope scales and the logit scale fold into the query rows
//     in f32: s = (q_lat * (ckv_scale * scale)) . ckv_q
//               + (q_rope * (krope_scale * scale)) . krope_q;
//   * positions > cache_pos[slot] are masked with -1e30 (not -inf), so a
//     slot with no valid position (cache_pos < 0) gets the finite uniform
//     average over all S that the plain version gives; positions past S do
//     not exist here (no padding) and weigh exactly 0;
//   * context = acc / l * ckv_scale, cast to q_lat's type.
// A live slot skips the blocks past its cache_pos: their weights are
// exactly 0 (exp(-1e30 - m) underflows) in the plain version too.  An idle
// slot walks all of S.
//
// What bounds it on an H100: the operations.  All H heads share one latent
// stream, so every byte of ckv_q / krope_q feeds 2*H multiply-adds
// (2*B*H*S*(2L+R) FLOP against B*S*(L+R) bytes): about 2.3 GFLOP on 6 MB at
// the served shape.  Simple first: f32 FMAs on int8 bytes unpacked in
// registers; each staged latent word serves several heads (a thread keeps
// one word column and up to 4 heads of the context in registers); blocks
// of 64 positions staged with asynchronous 4-byte copies (cp.async), the
// next block in flight while this one is used, rows padded by one word so
// a warp's per-position dot products hit distinct banks.  mma / wgmma on
// the latents is later work.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dal {

constexpr int THREADS = 256;
constexpr int BS = 64;                     // positions per staged block
constexpr int MAX_HG = 8;                  // heads per CTA
constexpr int LROWS = THREADS / BS;        // heads one logit pass covers
constexpr int MAX_LG = MAX_HG / LROWS;     // logit heads per thread
constexpr int MAX_CG = 4;                  // context heads per thread
constexpr float NEG = -1e30f;              // the reference's mask value

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

// Whether a geometry is taken: L a multiple of 4 whose L/4 words divide
// THREADS (a thread keeps one word column of the context), R a multiple of
// 4, 1 <= HG <= MAX_HG, and at most MAX_CG context heads per thread.
__host__ __device__ inline bool takes(int L, int R, int HG) {
  if (L < 4 || L % 4 || THREADS % (L / 4) || R < 4 || R % 4) return false;
  if (HG < 1 || HG > MAX_HG) return false;
  return HG <= (THREADS / (L / 4)) * MAX_CG;
}

// Two staging buffers of one block each: (BS, L/4 + 1) + (BS, R/4 + 1)
// words.
__host__ __device__ inline size_t stage_words(int L, int R) {
  return (size_t)BS * (L / 4 + 1) + (size_t)BS * (R / 4 + 1);
}

inline size_t smem_bytes(int L, int R, int HG) {
  return 4 * ((size_t)HG * (L + R + BS) + 3 * MAX_HG + 2 * stage_words(L, R));
}

// Stage block s0 of a slot's latents into one buffer (Cs rows padded to
// LW + 1 words, Rs rows to RW + 1) with asynchronous 4-byte copies; the
// caller commits and waits.  A thread keeps one word column of ckv.
__device__ __forceinline__ void stage(int* Cs, int* Rs, const int* cw,
                                      const int* rw, int s0, int npos,
                                      int LW, int RW, int cw0, int cg0,
                                      int cstep) {
  for (int p = cg0; p < npos; p += cstep)          // LW divides THREADS
    __pipeline_memcpy_async(Cs + p * (LW + 1) + cw0,
                            cw + (size_t)(s0 + p) * LW + cw0, 4);
  for (int e = threadIdx.x; e < npos * RW; e += THREADS) {
    const int p = e / RW, w = e % RW;
    __pipeline_memcpy_async(Rs + p * (RW + 1) + w,
                            rw + (size_t)(s0 + p) * RW + w, 4);
  }
}

// ql (B,H,L), qr (B,H,R) T; cq (B,S,L), rq (B,S,R) int8; cs (B,L),
// rs (B,R) f32; cache_pos (B,) int32; out (B,H,L) T.  Grid
// (ceil(H/HG), B); HG heads per CTA (the last group may hold fewer).
template <typename T>
__global__ void __launch_bounds__(THREADS)
latent_kernel(const T* __restrict__ ql, const T* __restrict__ qr,
              const int8_t* __restrict__ cq, const float* __restrict__ cs,
              const int8_t* __restrict__ rq, const float* __restrict__ rs,
              const int* __restrict__ cache_pos, T* __restrict__ out, int S,
              int H, int L, int R, int HG, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int LW = L / 4, RW = R / 4;
  float* Qs = smem;                                  // (HG, L) folded
  float* Qr = Qs + (size_t)HG * L;                   // (HG, R) folded
  float* Ps = Qr + (size_t)HG * R;                   // (HG, BS)
  float* m_s = Ps + (size_t)HG * BS;
  float* l_s = m_s + MAX_HG;
  float* a_s = l_s + MAX_HG;
  int* stage0 = reinterpret_cast<int*>(a_s + MAX_HG);  // 2 buffers
  const size_t sw = stage_words(L, R);

  const int b = blockIdx.y, h0 = blockIdx.x * HG;
  const int hg = min(HG, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cp = cache_pos[b];
  const int n_valid = cp < 0 ? S : min(S, cp + 1);
  const float* csb = cs + (size_t)b * L;
  const float* rsb = rs + (size_t)b * R;
  const int* cw = reinterpret_cast<const int*>(cq + (size_t)b * S * L);
  const int* rw = reinterpret_cast<const int*>(rq + (size_t)b * S * R);

  const T* qlb = ql + ((size_t)b * H + h0) * L;
  const T* qrb = qr + ((size_t)b * H + h0) * R;
  for (int i = tid; i < hg * L; i += THREADS)
    Qs[i] = to_f32(qlb[i]) * (csb[i % L] * scale);
  for (int i = tid; i < hg * R; i += THREADS)
    Qr[i] = to_f32(qrb[i]) * (rsb[i % R] * scale);
  if (tid < MAX_HG) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  // Logit work: position lp, heads lg0 + LROWS*k.  Context work: word
  // column cw0 (channels 4*cw0 .. +3), heads cg0 + cstep*k.
  const int lp = tid % BS, lg0 = tid / BS;
  const int cstep = THREADS / LW;
  const int cw0 = tid % LW, cg0 = tid / LW;
  float acc[MAX_CG][4];
#pragma unroll
  for (int k = 0; k < MAX_CG; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
  // Double-buffered: block s0 + BS streams in while block s0 is used.
  stage(stage0, stage0 + (size_t)BS * (LW + 1), cw, rw, 0, min(BS, S), LW,
        RW, cw0, cg0, cstep);
  __pipeline_commit();
  int buf = 0;
  for (int s0 = 0; s0 < n_valid; s0 += BS, buf ^= 1) {
    const int npos = min(BS, S - s0);
    const int* Cs = stage0 + buf * sw;
    const int* Rs = Cs + (size_t)BS * (LW + 1);
    __pipeline_wait_prior(0);
    __syncthreads();            // this block staged; the other buffer free
    if (s0 + BS < n_valid) {
      int* next = stage0 + (buf ^ 1) * sw;
      stage(next, next + (size_t)BS * (LW + 1), cw, rw, s0 + BS,
            min(BS, S - s0 - BS), LW, RW, cw0, cg0, cstep);
      __pipeline_commit();
    }

    // Logits of this block; -inf marks a position past S (weight 0).
    {
      float dot[MAX_LG];
#pragma unroll
      for (int k = 0; k < MAX_LG; ++k) dot[k] = 0.f;
      if (lp < npos) {
        const int* crow = Cs + lp * (LW + 1);
        for (int w = 0; w < LW; ++w) {
          const int word = crow[w];
          const float c0 = byte_f32(word, 0), c1 = byte_f32(word, 1);
          const float c2 = byte_f32(word, 2), c3 = byte_f32(word, 3);
#pragma unroll
          for (int k = 0; k < MAX_LG; ++k) {
            const int g = lg0 + LROWS * k;
            if (g < hg) {
              const float4 q =
                  reinterpret_cast<const float4*>(Qs + (size_t)g * L)[w];
              dot[k] += q.x * c0 + q.y * c1 + q.z * c2 + q.w * c3;
            }
          }
        }
        const int* rrow = Rs + lp * (RW + 1);
        for (int w = 0; w < RW; ++w) {
          const int word = rrow[w];
          const float c0 = byte_f32(word, 0), c1 = byte_f32(word, 1);
          const float c2 = byte_f32(word, 2), c3 = byte_f32(word, 3);
#pragma unroll
          for (int k = 0; k < MAX_LG; ++k) {
            const int g = lg0 + LROWS * k;
            if (g < hg) {
              const float4 q =
                  reinterpret_cast<const float4*>(Qr + (size_t)g * R)[w];
              dot[k] += q.x * c0 + q.y * c1 + q.z * c2 + q.w * c3;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_LG; ++k) {
        const int g = lg0 + LROWS * k;
        if (g < hg)
          Ps[g * BS + lp] =
              lp < npos ? (s0 + lp <= cp ? dot[k] : NEG) : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, one warp per head row.
    for (int g = warp; g < hg; g += THREADS / 32) {
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

    // Context: acc[k] = acc[k] * alpha + sum_p P[g, p] * ckv_q[p, 4*cw0..].
#pragma unroll
    for (int k = 0; k < MAX_CG; ++k) {
      const int g = cg0 + cstep * k;
      if (g < hg) {
        const float a = a_s[g];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] *= a;
      }
    }
    for (int p = 0; p < npos; ++p) {
      const int word = Cs[p * (LW + 1) + cw0];
      const float c0 = byte_f32(word, 0), c1 = byte_f32(word, 1);
      const float c2 = byte_f32(word, 2), c3 = byte_f32(word, 3);
#pragma unroll
      for (int k = 0; k < MAX_CG; ++k) {
        const int g = cg0 + cstep * k;
        if (g < hg) {
          const float pw = Ps[g * BS + p];
          acc[k][0] += pw * c0;
          acc[k][1] += pw * c1;
          acc[k][2] += pw * c2;
          acc[k][3] += pw * c3;
        }
      }
    }
  }

  T* ob = out + ((size_t)b * H + h0) * L;
#pragma unroll
  for (int k = 0; k < MAX_CG; ++k) {
    const int g = cg0 + cstep * k;
    if (g < hg) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cw0 + j;
        ob[(size_t)g * L + c] = from_f32<T>(acc[k][j] / l_s[g] * csb[c]);
      }
    }
  }
}

template <typename T>
int launch(const void* ql, const void* qr, const void* cq, const void* cs,
           const void* rq, const void* rs, const void* cache_pos, void* out,
           int B, int S, int H, int L, int R, int HG, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(L, R, HG);
  cudaError_t err = cudaFuncSetAttribute(
      latent_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  latent_kernel<T><<<dim3((H + HG - 1) / HG, B), THREADS, smem, stream>>>(
      static_cast<const T*>(ql), static_cast<const T*>(qr),
      static_cast<const int8_t*>(cq), static_cast<const float*>(cs),
      static_cast<const int8_t*>(rq), static_cast<const float*>(rs),
      static_cast<const int*>(cache_pos), static_cast<T*>(out), S, H, L, R,
      HG, scale);
  return (int)cudaGetLastError();
}

}  // namespace dal

extern "C" {

// Dynamic shared memory of one launch (bytes) at latent width L, rope
// width R and HG heads per CTA; 0 if the kernel does not take the
// geometry (see dal::takes).
size_t lrk_decode_attention_latent_q_smem(int L, int R, int HG) {
  return dal::takes(L, R, HG) ? dal::smem_bytes(L, R, HG) : 0;
}

// out (B,H,L) = absorbed-form attention of q_lat (B,H,L) / q_rope (B,H,R)
// over the int8 latent pool ckv_q (B,S,L) / krope_q (B,S,R) with
// per-(slot, channel) scales ckv_scale (B,L) / krope_scale (B,R) f32 and
// positions <= cache_pos (B,) int32, logit scale `scale`; HG heads per CTA;
// all contiguous.  dtype: 0 = float32, 1 = bfloat16 (q_lat, q_rope, out).
// Returns the launch's cudaError_t (0 on success).
int lrk_decode_attention_latent_q(int dtype, const void* ql, const void* qr,
                                  const void* cq, const void* cs,
                                  const void* rq, const void* rs,
                                  const void* cache_pos, void* out, int B,
                                  int S, int H, int L, int R, int HG,
                                  float scale, void* stream) {
  if (S < 1 || !dal::takes(L, R, HG)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dal::launch<float>(ql, qr, cq, cs, rq, rs, cache_pos, out, B, S,
                              H, L, R, HG, scale, s);
  if (dtype == 1)
    return dal::launch<__nv_bfloat16>(ql, qr, cq, cs, rq, rs, cache_pos, out,
                                      B, S, H, L, R, HG, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
