// One-token GQA decode attention over a paged KV pool (sm_90a): the pool
// is a heap of fixed-size physical blocks, and each stream reaches its
// positions through a row of a block table.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention_paged.py:
//   decode_attention_paged   (pl.pallas_call at :135) -- full-width pool;
//   decode_attention_paged_q (pl.pallas_call at :236) -- int8 pool with one
//                            f32 scale row per physical block.
// There the block table is a scalar-prefetch operand that aims each grid
// step's DMA at bt[slot, blk], and the grid (B, KH, nblk) carries the
// online-softmax state across the in-order block axis in VMEM.  GPU blocks
// run in no order, so here one CTA owns one (slot, KV head) pair and walks
// the slot's table itself; the pool is never gathered into a contiguous
// copy (the plain version's gather is exactly what this avoids).
//
// Math, as the TPU kernels do it:
//   * full width: s = (q * 1/sqrt(D)) . k; int8: the block's K scale folds
//     into the query, s = (q * (k_scale[blk] * 1/sqrt(D))) . k_q;
//   * softcap (if nonzero) before the mask; positions > cache_pos[slot]
//     are masked with -1e30 (not -inf), so a slot with no valid position
//     (cache_pos < 0) gets the plain version's finite uniform average over
//     every position of its table, dummy entries included;
//   * int8: each block's V scale multiplies that block's contribution
//     before it is accumulated (it changes block to block, so it cannot
//     fold into the output as the slot kernel's does);
//   * output acc / l, cast to q's type.
// Table entries past cache_pos // bs are skipped when the slot has a
// valid position: their weights are exp(-1e30 - m) = 0 exactly, so the
// skip equals the plain version's masked sum as long as the (dummy) block
// holds finite values.
//
// What bounds it on an H100: the live blocks' bytes (2 * live positions
// * D per head, at 1 byte int8 or 2 bytes bf16) -- a handful of FLOPs per
// byte.  Simple first: B*KH CTAs of 128 threads; each pass stages up to
// 64 positions (whole table entries when bs < 64) through shared memory
// with 16-byte loads, rows padded by one word so per-position dot
// products hit distinct banks; plain f32 FMAs.  Splitting a long table
// across CTAs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dap {

constexpr int THREADS = 128;
constexpr int P = 64;            // positions staged per pass
constexpr int MAX_D = 256;
constexpr int MAX_G = 16;
constexpr int MAX_OUT = 8;       // (g, d) outputs per thread
constexpr int MAX_CB = 8;        // table entries per pass (bs < P)
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG = -1e30f;    // the reference's mask value

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

// Pool element types: value d of a staged row of 32-bit words.
template <typename E> struct Elem;
template <> struct Elem<int8_t> {
  __device__ __forceinline__ static float at(const int* row, int d) {
    return (float)((int)((unsigned)row[d >> 2] << (24 - 8 * (d & 3))) >> 24);
  }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float at(const int* row, int d) {
    const unsigned w = (unsigned)row[d >> 1];
    return __uint_as_float((d & 1 ? w >> 16 : w & 0xffffu) << 16);
  }
};
template <> struct Elem<float> {
  __device__ __forceinline__ static float at(const int* row, int d) {
    return __int_as_float(row[d]);
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Table entries staged per pass, and words per staged row.
__host__ __device__ inline int entries_per_pass(int bs) {
  return bs >= P ? 1 : (P / bs < MAX_CB ? P / bs : MAX_CB);
}
__host__ __device__ inline int row_words(int D, int esize) {
  return D * esize / 4 + 1;
}

inline size_t smem_bytes(int G, int D, int bs, int esize) {
  const size_t rw = row_words(D, esize);
  const size_t cb = entries_per_pass(bs);
  return 4 * (2 * P * rw        // K, V rows
              + (size_t)G * D   // query rows
              + (size_t)G * P   // logits / weights
              + 2 * cb * D      // per-entry K, V scale rows
              + P);             // staged position -> entry of the pass
}

// q (B,KH,G,D) T; k/v (NB+1, bs, KH, D) E; ks/vs (NB+1, KH, D) f32 (QUANT
// only); bt (B, nblk) int32; cache_pos (B,) int32; out (B,KH,G,D) T.
// Grid (KH, B).
template <typename T, typename E, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const E* __restrict__ k,
             const float* __restrict__ ks, const E* __restrict__ v,
             const float* __restrict__ vs, const int* __restrict__ bt,
             const int* __restrict__ cache_pos, T* __restrict__ out,
             int nblk, int bs, int KH, int G, int D, float scale,
             float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rw = row_words(D, sizeof(E));
  const int CB = entries_per_pass(bs);
  int* Ks = reinterpret_cast<int*>(smem);
  int* Vs = Ks + P * rw;
  float* Qs = reinterpret_cast<float*>(Vs + P * rw);   // query rows
  float* Ps = Qs + G * D;                              // logits, weights
  float* KSs = Ps + G * P;                             // k scale / sqrt(D)
  float* VSs = KSs + CB * D;                           // v scale
  int* PE = reinterpret_cast<int*>(VSs + CB * D);      // entry of position
  __shared__ float m_s[MAX_G], l_s[MAX_G], a_s[MAX_G];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_out = G * D;
  const int chunks = D * (int)sizeof(E) / 16;          // 16-byte loads/row
  const int cp = cache_pos[b];
  const int walk = cp < 0 ? nblk : min(nblk, cp / bs + 1);
  const int total = walk * bs;
  const size_t pos_stride = (size_t)KH * D;           // elements
  const int* table = bt + (size_t)b * nblk;
  const T* qb = q + ((size_t)b * KH + h) * G * D;

  for (int i = tid; i < n_out; i += THREADS)
    Qs[i] = QUANT ? to_f32(qb[i]) : to_f32(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < total;) {
    const int e0 = s0 / bs;                            // first entry
    const int npos = bs >= P ? min(P, min((e0 + 1) * bs, total) - s0)
                             : min(CB * bs, total - s0);
    const int ncb = (s0 + npos - 1) / bs - e0 + 1;
    for (int e = tid; e < npos * chunks; e += THREADS) {
      const int p = e / chunks, c = e % chunks;
      const int lp = s0 + p;
      const size_t phys = (size_t)table[lp / bs];
      const size_t off = (phys * bs + lp % bs) * pos_stride + (size_t)h * D;
      const int4 kv = reinterpret_cast<const int4*>(k + off)[c];
      const int4 vv = reinterpret_cast<const int4*>(v + off)[c];
      int* kr = Ks + p * rw + c * 4;
      int* vr = Vs + p * rw + c * 4;
      kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
      vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
      if (c == 0) PE[p] = lp / bs - e0;
    }
    if (QUANT) {
      for (int e = tid; e < ncb * D; e += THREADS) {
        const int cb = e / D, d = e % D;
        const size_t row = ((size_t)table[e0 + cb] * KH + h) * D + d;
        KSs[e] = ks[row] * scale;
        VSs[e] = vs[row];
      }
    }
    __syncthreads();

    // Logits of this pass; -inf marks a slot past npos (weight 0).
    for (int e = tid; e < G * P; e += THREADS) {
      const int g = e / P, p = e % P;
      float s = -INFINITY;
      if (p < npos) {
        const int* kr = Ks + p * rw;
        const float* qr = Qs + g * D;
        float dot = 0.f;
        if (QUANT) {
          const float* kscale = KSs + PE[p] * D;
          for (int d = 0; d < D; ++d)
            dot += __fmul_rn(qr[d], kscale[d]) * Elem<E>::at(kr, d);
        } else {
          for (int d = 0; d < D; ++d) dot += qr[d] * Elem<E>::at(kr, d);
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
      for (int p = lane; p < P; p += 32) mx = fmaxf(mx, Ps[g * P + p]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < P; p += 32) {
        const float sv = Ps[g * P + p];
        const float w = sv == -INFINITY ? 0.f : expf(sv - m_new);
        Ps[g * P + p] = w;
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
    for (int j = 0; j < MAX_OUT; ++j) {
      const int o = tid + j * THREADS;
      if (o < n_out) {
        const int g = o / D, d = o % D;
        const float* pr = Ps + g * P;
        float a = acc[j] * a_s[g];
        if (QUANT) {
          // one partial sum per table entry, scaled by its V scale
          int cur = 0;
          float part = 0.f;
          for (int p = 0; p < npos; ++p) {
            if (PE[p] != cur) {
              a += part * VSs[cur * D + d];
              part = 0.f;
              cur = PE[p];
            }
            part += pr[p] * Elem<E>::at(Vs + p * rw, d);
          }
          a += part * VSs[cur * D + d];
        } else {
          for (int p = 0; p < npos; ++p)
            a += pr[p] * Elem<E>::at(Vs + p * rw, d);
        }
        acc[j] = a;
      }
    }
    __syncthreads();
    s0 += npos;
  }

  T* ob = out + ((size_t)b * KH + h) * G * D;
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int o = tid + j * THREADS;
    if (o < n_out) ob[o] = from_f32<T>(acc[j] / l_s[o / D]);
  }
}

template <typename T, typename E, bool QUANT>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* bt, const void* cache_pos, void* out,
           int B, int nblk, int bs, int KH, int G, int D, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D, bs, sizeof(E));
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = paged_kernel<T, E, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<dim3(KH, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k),
      static_cast<const float*>(ks), static_cast<const E*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(cache_pos), static_cast<T*>(out), nblk, bs, KH,
      G, D, scale, softcap);
  return (int)cudaGetLastError();
}

bool fits(int G, int D, int bs, int esize) {
  return D >= 16 && D % 16 == 0 && D <= MAX_D && G >= 1 && G <= MAX_G &&
         G * D <= THREADS * MAX_OUT && bs >= 1 &&
         smem_bytes(G, D, bs, esize) <= (size_t)SMEM_LIMIT;
}

}  // namespace dap

extern "C" {

// Whether the kernels take this geometry (esize: bytes per pool value,
// 1 int8, 2 bf16, 4 f32): D a multiple of 16 up to 256, at most 16 query
// heads per KV head, G*D <= 1024, and the pass fitting shared memory.
int lrk_decode_attention_paged_fits(int G, int D, int bs, int esize) {
  return dap::fits(G, D, bs, esize);
}

// out (B,KH,G,D) = attention of q (B,KH,G,D) over the full-width paged
// pool k/v (NB+1, bs, KH, D) through block tables bt (B, nblk) int32, at
// positions <= cache_pos (B,) int32; pool in q's type.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t.
int lrk_decode_attention_paged(int dtype, const void* q, const void* k,
                               const void* v, const void* bt,
                               const void* cache_pos, void* out, int B,
                               int nblk, int bs, int KH, int G, int D,
                               float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dap::fits(G, D, bs, 4))
    return dap::launch<float, float, false>(q, k, nullptr, v, nullptr, bt,
                                            cache_pos, out, B, nblk, bs, KH,
                                            G, D, softcap, s);
  if (dtype == 1 && dap::fits(G, D, bs, 2))
    return dap::launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, nullptr, v, nullptr, bt, cache_pos, out, B, nblk, bs, KH, G, D,
        softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 twin: k/v (NB+1, bs, KH, D) int8 with per-block scale rows
// ks/vs (NB+1, KH, D) f32.  dtype (q, out): 0 = float32, 1 = bfloat16.
int lrk_decode_attention_paged_q(int dtype, const void* q, const void* k,
                                 const void* ks, const void* v,
                                 const void* vs, const void* bt,
                                 const void* cache_pos, void* out, int B,
                                 int nblk, int bs, int KH, int G, int D,
                                 float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dap::fits(G, D, bs, 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dap::launch<float, int8_t, true>(q, k, ks, v, vs, bt, cache_pos,
                                            out, B, nblk, bs, KH, G, D,
                                            softcap, s);
  if (dtype == 1)
    return dap::launch<__nv_bfloat16, int8_t, true>(
        q, k, ks, v, vs, bt, cache_pos, out, B, nblk, bs, KH, G, D, softcap,
        s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
