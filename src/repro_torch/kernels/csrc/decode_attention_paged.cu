// One-token GQA decode attention over a paged KV pool (sm_90a): the pool
// is a heap of fixed-size physical blocks, and each stream reaches its
// positions through a row of a block table.  The split kernel also reads
// the int8 slot pool in place, where a slot's positions are one
// contiguous run (the simplest paged pool: no table).
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention_paged.py:
//   decode_attention_paged   (pl.pallas_call at :135) -- full-width pool;
//   decode_attention_paged_q (pl.pallas_call at :236) -- int8 pool with one
//                            f32 scale row per physical block;
// and of src/repro/kernels/decode_attention_q.py:
//   decode_attention_q       (pl.pallas_call at :126) -- the int8 slot
//                            pool (B, S, KH, D) with one f32 scale row
//                            per (slot, KV head).
// There the block table is a scalar-prefetch operand that aims each grid
// step's DMA at bt[slot, blk], and the grid (B, KH, nblk) carries the
// online-softmax state across the in-order block axis in VMEM.  GPU blocks
// run in no order, so here each CTA walks (part of) a slot's table itself;
// the pool is never gathered into a contiguous copy (the plain version's
// gather is exactly what this avoids).
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
// * D per head, at 1 byte int8, 2 bytes bf16 or 4 bytes f32) -- a handful
// of FLOPs per byte; about 6 MB, 2.3 us, per int8 launch at the served
// pool (8 slots x 8 KV heads, 64 entries of 16 positions), twice that in
// bf16.  Two kernels:
//
//   * paged_split_kernel (every pool: B9 int8, B8 bf16 and f32, and, as
//     its SLOT view, B5's int8 slot pool): the sequence split across the
//     card.  Grid (KH, B, splits), splits of
//     `span` table entries from paged_split in
//     kernels/decode_attention_paged.py (about four CTAs per SM: 8 splits
//     of 8 entries, 512 CTAs, at the served pool; the planner shrinks the
//     span where a wide element's ring would not fit shared memory); a
//     live slot's split that starts past cache_pos // bs writes an empty
//     partial (m = -inf, l = 0), an idle slot's splits walk their whole
//     ranges.  Whole table entries (K and V rows and, int8, both scale
//     rows) are staged by 16-byte cp.async into a ring of up to 3 passes,
//     so two passes are in flight while one is used, behind one barrier
//     per pass.  One warp per query row (G warps): each lane takes two
//     positions' logits (f32 FMAs on 16-byte chunks of the row: 16 int8,
//     8 bf16 or 4 f32 values; int8 folds the block's K scale per value),
//     the softmax is the warp's own (shuffles, no barrier), and each lane
//     accumulates its D / 32 output values entry by entry (int8: each
//     entry's sum times its V scale).  The splits' f32 partials are folded
//     inside the launch: the last CTA of each (slot, KV head) to take an
//     atomic ticket sums them in split order (so a second call gives the
//     same bits) and resets the ticket.  The slot view (B5) takes entries
//     of SLOT_ENTRY = 64 positions of the slot's own run (one pass each,
//     the last one cut at S, so a ragged S stages nothing of the next
//     slot), 8 splits of 2 entries, 512 CTAs, at the served pool (8 slots
//     of 1,024 positions x 8 KV heads); with one scale row per slot it
//     folds the K scale into the query once and the V scale into the
//     fold's result, as the TPU kernel does, and stages no scale rows.
//   * paged_kernel (the earlier design of both, kept callable as
//     lrk_decode_attention_paged_prev and lrk_decode_attention_paged_q_prev
//     for chip_smoke's prev_ms; the serve path never launches it): B*KH
//     CTAs of 128 threads, each walking its slot's whole table; each pass
//     stages up to 64 positions (whole table entries when bs < 64) through
//     shared memory with 16-byte loads, rows padded by one word so
//     per-position dot products hit distinct banks; plain f32 FMAs; three
//     barriers per pass.
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


// ---------------------------------------------------------------------------
// The sequence-split kernel, on an int8 (B9), bf16 or f32 (B8) pool
// element type E.
// ---------------------------------------------------------------------------

constexpr int SPLIT_P = 64;       // positions of one pass
constexpr int SPLIT_STAGES = 3;   // ring depth, in passes
constexpr int MAX_CE = 16;        // table entries of one pass (bs < 64)
constexpr int MAX_SPLITS = 32;    // a lane per split in the fold
constexpr int SLOT_ENTRY = 64;    // positions of a slot pool's entry (B5)

// Positions of a pass and the table entries (scale rows) it may touch: whole
// entries up to 64 positions where bs < 64, else 64 positions of at most two
// entries.
__host__ __device__ inline int pass_entries(int bs) {
  return bs >= SPLIT_P ? 2 : (SPLIT_P / bs < MAX_CE ? SPLIT_P / bs : MAX_CE);
}
__host__ __device__ inline int pass_positions(int bs) {
  return bs >= SPLIT_P ? SPLIT_P : pass_entries(bs) * bs;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Ring stages a split of `span` table entries uses: one per pass, at most
// SPLIT_STAGES (a split of one pass holds one stage of shared memory, so
// more CTAs fit an SM).
__host__ __device__ inline int ring_stages(int bs, int span) {
  const int passes = (span * bs + pass_positions(bs) - 1) / pass_positions(bs);
  return passes < SPLIT_STAGES ? passes : SPLIT_STAGES;
}

// One ring stage: SPLIT_P K rows and SPLIT_P V rows of D values (rows
// padded by 16 bytes), then (QUANT) pass_entries K and V scale rows of D
// f32 (padded by 4).
__host__ __device__ inline size_t stage_bytes(int D, int bs, int esize,
                                              bool quant) {
  const size_t rb = (size_t)D * esize + 16;
  return align16(2 * SPLIT_P * rb +
                 (quant ? 2 * (size_t)pass_entries(bs) * (D + 4) * 4 : 0));
}

// The ring (ring_stages of them), the query rows (G, D) f32, (QUANT)
// each warp's query row folded with the K scale of each entry of the pass
// (G, pass_entries, D), the weights (G, SPLIT_P), the split's `span` table
// entries, the last-CTA flag.
__host__ __device__ inline size_t split_smem(int G, int D, int bs,
                                             int esize, bool quant,
                                             int span) {
  return ring_stages(bs, span) * stage_bytes(D, bs, esize, quant) +
         align16((size_t)G * D * 4) +
         (quant ? align16((size_t)G * pass_entries(bs) * D * 4) : 0) +
         align16((size_t)G * SPLIT_P * 4) + align16((size_t)span * 4) + 16;
}

// The 16 / sizeof(E) values of one 16-byte chunk, as f32.
template <typename E> struct Chunk;
// Signed byte j of a word as f32: byte + 128 as the low mantissa bits of
// 2^23, the float 2^23 + 128 + b exact, less 2^23 + 128 (a permute and an
// add, where I2F runs at a quarter of their rate).
__device__ __forceinline__ float byte_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u,
                                     0x7440u | j)) -
         8388736.f;
}

template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void get(const unsigned char* p,
                                             float (&f)[N]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[4 * i + j] = byte_f32(words[i], j);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(const unsigned char* p,
                                             float (&f)[N]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void get(const unsigned char* p,
                                             float (&f)[N]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  }
};

// Value d of a staged row.
template <typename E>
__device__ __forceinline__ float value_at(const unsigned char* row, int d) {
  if constexpr (sizeof(E) == 1)
    return byte_f32(*reinterpret_cast<const uint32_t*>(row + (d & ~3)),
                    d & 3);
  else
    return to_f32(reinterpret_cast<const E*>(row)[d]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the pass of np positions from position p0 of the split (counted
// from its first table entry; `table` is the split's slice of the block
// table, in shared memory), KV head h, into one ring stage.  SLOT: the
// slot pool, where the split's positions are one contiguous run starting
// at row `slot_row` (b * S + the split's first position) of the (B * S,
// KH, D) pool, and there is no table.
template <typename E, bool QUANT, bool SLOT>
__device__ __forceinline__ void stage_pass(
    unsigned char* st, const E* k, const float* ks, const E* v,
    const float* vs, const int* table, size_t slot_row, int p0, int np,
    int bs, int KH, int h, int D, int tid, int nthreads) {
  const int rb = D * (int)sizeof(E) + 16;
  const int chunks = D * (int)sizeof(E) / 16;
  unsigned char* Ks = st;
  unsigned char* Vs = st + SPLIT_P * rb;
  for (int e = tid; e < np * chunks; e += nthreads) {
    const int p = e / chunks, c = e % chunks;
    const int lp = p0 + p;
    const size_t row =
        SLOT ? slot_row + lp : (size_t)table[lp / bs] * bs + lp % bs;
    const size_t off = (row * KH + h) * (size_t)D * sizeof(E) + 16 * c;
    cp_async16(Ks + p * rb + 16 * c,
               reinterpret_cast<const unsigned char*>(k) + off);
    cp_async16(Vs + p * rb + 16 * c,
               reinterpret_cast<const unsigned char*>(v) + off);
  }
  if (QUANT) {
    float* KSs = reinterpret_cast<float*>(st + 2 * SPLIT_P * rb);
    float* VSs = KSs + pass_entries(bs) * (D + 4);
    const int e0 = p0 / bs, ne = (p0 + np - 1) / bs - e0 + 1;
    const int sc = D / 4;  // 16-byte chunks of a scale row
    for (int e = tid; e < ne * sc; e += nthreads) {
      const int ce = e / sc, c = e % sc;
      const size_t row = ((size_t)table[e0 + ce] * KH + h) * D + 4 * c;
      cp_async16(KSs + ce * (D + 4) + 4 * c, ks + row);
      cp_async16(VSs + ce * (D + 4) + 4 * c, vs + row);
    }
  }
}

// q (B,KH,G,D) T; k/v (NB+1, bs, KH, D) E; ks/vs (NB+1, KH, D) f32 (QUANT
// only); bt (B, nblk) int32; cache_pos (B,) int32; out (B,KH,G,D) T.
// part: the f32 partials, acc (B, KH, splits, G, D) then (m, l) (B, KH,
// splits, G, 2); tickets (B, KH) int32, zero before the launch and left
// zero.  Grid (KH, B, splits), 32*G threads: warp g owns query row g.
// Split j owns table entries [j*span, (j+1)*span), positions [j*span*bs,
// min((j+1)*span*bs, S)); S = nblk * bs on a paged pool.  ND = ceil(D /
// 32) output values per lane (1, 2, 4 or 8).
// SLOT (B5; E int8, QUANT false): the int8 slot pool k/v (B, S, KH, D),
// entries of bs positions of a slot's own contiguous run (no table, bt
// unused); ks/vs (B, KH, D) f32, one scale row per (slot, head): the K
// scale and 1/sqrt(D) fold into the query once, the raw int8 V values are
// summed, and the V scale multiplies the fold's result, o = (sum_j c_j
// acc_j) / L * v_scale (decode_attention_q.py:95-98).
template <typename T, typename E, bool QUANT, bool SLOT, int ND>
__global__ void __launch_bounds__(32 * MAX_G)
paged_split_kernel(const T* __restrict__ q, const E* __restrict__ k,
                   const float* __restrict__ ks, const E* __restrict__ v,
                   const float* __restrict__ vs, const int* __restrict__ bt,
                   const int* __restrict__ cache_pos, T* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ tickets,
                   int nblk, int bs, int S, int KH, int G, int D, int span,
                   float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t sb = stage_bytes(D, bs, sizeof(E), QUANT);
  const int rb = D * (int)sizeof(E) + 16;
  const int NE = pass_entries(bs);
  float* Qs = reinterpret_cast<float*>(smem + ring_stages(bs, span) * sb);
  float* Qk = Qs + align16((size_t)G * D * 4) / 4;
  float* Pw = Qk + (QUANT ? align16((size_t)G * NE * D * 4) / 4 : 0);
  int* Tb = reinterpret_cast<int*>(Pw + align16((size_t)G * SPLIT_P * 4) / 4);
  int* flag = Tb + align16((size_t)span * 4) / 4;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int nthreads = 32 * G;
  const int tid = threadIdx.x, g = tid >> 5, lane = tid & 31;
  const int cp = cache_pos[b];
  const int walk = cp < 0 ? nblk : min(nblk, cp / bs + 1);
  const int e_end = min(walk, (split + 1) * span);
  const int p_begin = split * span * bs;
  const int p_end = min(e_end * bs, S);
  const bool live = split * span < e_end;
  const int PP = pass_positions(bs);
  const int npass = live ? (p_end - p_begin + PP - 1) / PP : 0;
  const size_t group = (size_t)b * KH + h;  // this (slot, KV head)
  const size_t slot_row = (size_t)b * S + p_begin;  // SLOT: the split's run
  float* MLbase = part + (size_t)gridDim.y * KH * nsplit * G * D;

  const T* qb = q + group * G * D;
  for (int i = tid; i < G * D; i += nthreads)
    Qs[i] = SLOT    ? __fmul_rn(to_f32(qb[i]),
                                __fmul_rn(ks[group * D + i % D], scale))
            : QUANT ? to_f32(qb[i])
                    : to_f32(qb[i]) * scale;
  // the split's table entries, read once
  if (!SLOT)
    for (int e = tid; e < e_end - split * span; e += nthreads)
      Tb[e] = bt[(size_t)b * nblk + split * span + e];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SPLIT_STAGES - 1; ++s) {
    if (s < npass)
      stage_pass<E, QUANT, SLOT>(smem + s * sb, k, ks, v, vs, Tb, slot_row,
                                 s * PP, min(PP, p_end - p_begin - s * PP),
                                 bs, KH, h, D, tid, nthreads);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float m = -INFINITY, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  const float* qg = Qs + g * D;
  float* pw = Pw + g * SPLIT_P;
  for (int i = 0; i < npass; ++i) {
    cp_async_wait<SPLIT_STAGES - 2>();  // this thread's copies of pass i
    __syncthreads();  // everyone's; pass i - 1's stage is no longer read
    const int pf = i + SPLIT_STAGES - 1;
    if (pf < npass)
      stage_pass<E, QUANT, SLOT>(smem + (pf % SPLIT_STAGES) * sb, k, ks, v,
                                 vs, Tb, slot_row, pf * PP,
                                 min(PP, p_end - p_begin - pf * PP), bs, KH,
                                 h, D, tid, nthreads);
    cp_async_commit();

    const unsigned char* st = smem + (i % SPLIT_STAGES) * sb;
    const unsigned char* Ks = st;
    const unsigned char* Vs = st + SPLIT_P * rb;
    const float* KSs = reinterpret_cast<const float*>(st + 2 * SPLIT_P * rb);
    const float* VSs = KSs + NE * (D + 4);
    const int p0 = p_begin + i * PP;
    const int np = min(PP, p_end - p0);
    const int e0 = p0 / bs;
    float* qk = Qk + g * NE * D;
    if (QUANT) {  // q * (k_scale[entry] * 1/sqrt(D)) for each entry
      const int ne = (p0 + np - 1) / bs - e0 + 1;
      for (int e = lane; e < ne * D; e += 32) {
        const int ce = e / D, d = e % D;
        qk[e] = __fmul_rn(qg[d], __fmul_rn(KSs[ce * (D + 4) + d], scale));
      }
      __syncwarp();
    }

    // Logits of this warp's row; -inf marks a slot past the pass (weight 0).
    float sv[2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pp = lane + 32 * j;
      float s = -INFINITY;
      if (pp < np) {
        const int lp = p0 + pp;
        const unsigned char* kr = Ks + pp * rb;
        const float* qrow = QUANT ? qk + (lp / bs - e0) * D : qg;
        float dot = 0.f;
        constexpr int N = Chunk<E>::N;
#pragma unroll
        for (int c = 0; c < 32 * ND; c += N) {
          if (c < D) {
            float f[N];
            Chunk<E>::get(kr + c * sizeof(E), f);
#pragma unroll
            for (int x = 0; x < N; ++x) dot += qrow[c + x] * f[x];
          }
        }
        if (softcap != 0.f) dot = tanhf(dot / softcap) * softcap;
        s = lp <= cp ? dot : NEG;
      }
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float w = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
      pw[lane + 32 * j] = w;
      sum += w;
    }
    sum = warp_sum(sum);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // Context: one partial sum per table entry, scaled by its V scale.
#pragma unroll
    for (int x = 0; x < ND; ++x) acc[x] *= alpha;
    for (int pp = 0; pp < np;) {
      const int ent = (p0 + pp) / bs;
      const int stop = min(np, (ent + 1) * bs - p0);
      float sp[ND];
#pragma unroll
      for (int x = 0; x < ND; ++x) sp[x] = 0.f;
#pragma unroll 4
      for (; pp < stop; ++pp) {
        const float w = pw[pp];
        const unsigned char* vr = Vs + pp * rb;
#pragma unroll
        for (int x = 0; x < ND; ++x) {
          const int d = lane + 32 * x;
          if (d < D) sp[x] += w * value_at<E>(vr, d);
        }
      }
#pragma unroll
      for (int x = 0; x < ND; ++x) {
        const int d = lane + 32 * x;
        if (d < D)
          acc[x] += QUANT ? sp[x] * VSs[(ent - e0) * (D + 4) + d] : sp[x];
      }
    }
    __syncwarp();  // the weights are read before the next pass writes them
  }
  cp_async_wait<0>();

  // this split's partial: acc of this warp's row, then m, l
  const size_t pidx = group * nsplit + split;
  if (live) {
#pragma unroll
    for (int x = 0; x < ND; ++x) {
      const int d = lane + 32 * x;
      if (d < D) part[(pidx * G + g) * D + d] = acc[x];
    }
  }
  if (lane == 0) {
    MLbase[(pidx * G + g) * 2] = live ? m : -INFINITY;
    MLbase[(pidx * G + g) * 2 + 1] = live ? l : 0.f;
  }

  // The last CTA of this (slot, KV head) to finish folds the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + group, 1) == nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // warp g folds row g: lane j holds split j's (m, l); the max is exact in
  // any order, the sums are taken in split order
  const float* ml = MLbase + group * nsplit * G * 2;
  float mj = -INFINITY, lj = 0.f;
  if (lane < nsplit) {
    const float2 v = __ldcg(
        reinterpret_cast<const float2*>(ml + ((size_t)lane * G + g) * 2));
    mj = v.x;
    lj = v.y;
  }
  const float M = warp_max(mj);
  const float cj = mj == -INFINITY ? 0.f : expf(mj - M);
  const float pj = cj * lj;
  float Ls = 0.f;
  for (int j = 0; j < nsplit; ++j) Ls += __shfl_sync(0xffffffffu, pj, j);
  const float* a0 = part + group * nsplit * G * D;
  T* ob = out + (group * G + g) * D;
#pragma unroll
  for (int x = 0; x < ND; ++x) {
    const int d = lane + 32 * x;
    float o = 0.f;
#pragma unroll 8
    for (int j = 0; j < nsplit; ++j) {
      const float c = __shfl_sync(0xffffffffu, cj, j);
      // an empty split's acc was never written: its coefficient is 0
      const float v = __ldcg(a0 + ((size_t)j * G + g) * D + min(d, D - 1));
      if (c != 0.f) o += c * v;
    }
    if (d < D)
      ob[d] = from_f32<T>(SLOT ? __fmul_rn(o / Ls, vs[group * D + d])
                               : o / Ls);
  }
  if (tid == 0) tickets[group] = 0;
}

// Whether the split kernel takes a geometry: as fits(), with the ring in
// shared memory.
inline bool split_fits(int G, int D, int bs, int esize, bool quant,
                       int span) {
  return D >= 16 && D % 16 == 0 && D <= MAX_D && G >= 1 && G <= MAX_G &&
         bs >= 1 && span >= 1 &&
         split_smem(G, D, bs, esize, quant, span) <= (size_t)SMEM_LIMIT;
}

template <typename T, typename E, bool QUANT, bool SLOT = false>
int launch_split(const void* q, const void* k, const void* ks, const void* v,
                 const void* vs, const void* bt, const void* cache_pos,
                 void* out, void* part, void* tickets, int B, int nblk,
                 int bs, int S, int KH, int G, int D, int span, int nsplit,
                 float softcap, cudaStream_t stream) {
  if (!split_fits(G, D, bs, sizeof(E), QUANT, span) || nsplit < 1 ||
      nsplit > MAX_SPLITS || (long long)(nsplit - 1) * span >= nblk ||
      S < 1 || S > nblk * bs || S <= (nblk - 1) * bs)
    return (int)cudaErrorInvalidValue;
  const size_t smem = split_smem(G, D, bs, sizeof(E), QUANT, span);
  const int nd = (D + 31) / 32;
  const auto kernel = nd <= 1   ? paged_split_kernel<T, E, QUANT, SLOT, 1>
                      : nd <= 2 ? paged_split_kernel<T, E, QUANT, SLOT, 2>
                      : nd <= 4 ? paged_split_kernel<T, E, QUANT, SLOT, 4>
                                : paged_split_kernel<T, E, QUANT, SLOT, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<dim3(KH, B, nsplit), 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k),
      static_cast<const float*>(ks), static_cast<const E*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(cache_pos), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), nblk, bs, S, KH,
      G, D, span, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace dap

extern "C" {

// Whether the earlier kernel takes this geometry (esize: bytes per pool
// value, 1 int8, 2 bf16, 4 f32): D a multiple of 16 up to 256, at most 16
// query heads per KV head, G*D <= 1024, and the pass fitting shared
// memory.
int lrk_decode_attention_paged_fits(int G, int D, int bs, int esize) {
  return dap::fits(G, D, bs, esize);
}

// out (B,KH,G,D) = attention of q (B,KH,G,D) over the full-width paged
// pool k/v (NB+1, bs, KH, D) through block tables bt (B, nblk) int32, at
// positions <= cache_pos (B,) int32; pool in q's type.  dtype: 0 =
// float32, 1 = bfloat16.  On the split kernel: KH x B x nsplit CTAs,
// split j owning table entries [j*span, (j+1)*span); part the f32
// scratch of B * KH * nsplit * G * (D + 2) floats; tickets B * KH int32,
// zero (and zero again after the launch).  Returns the launch's
// cudaError_t.
int lrk_decode_attention_paged(int dtype, const void* q, const void* k,
                               const void* v, const void* bt,
                               const void* cache_pos, void* out, void* part,
                               void* tickets, int B, int nblk, int bs,
                               int KH, int G, int D, int span, int nsplit,
                               float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dap::launch_split<float, float, false>(
        q, k, nullptr, v, nullptr, bt, cache_pos, out, part, tickets, B,
        nblk, bs, nblk * bs, KH, G, D, span, nsplit, softcap, s);
  if (dtype == 1)
    return dap::launch_split<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, nullptr, v, nullptr, bt, cache_pos, out, part, tickets, B,
        nblk, bs, nblk * bs, KH, G, D, span, nsplit, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The earlier full-width kernel (one CTA per slot and KV head walking the
// whole table), kept for chip_smoke's prev_ms; operands as
// lrk_decode_attention_paged's, without the split's.
int lrk_decode_attention_paged_prev(int dtype, const void* q, const void* k,
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

// Whether the split kernel takes this geometry (esize: bytes per pool
// value; quant: with scale rows; span: table entries per split), and its
// dynamic shared memory (bytes).
int lrk_decode_attention_paged_split_fits(int G, int D, int bs, int esize,
                                          int quant, int span) {
  return dap::split_fits(G, D, bs, esize, quant != 0, span);
}
size_t lrk_decode_attention_paged_split_smem(int G, int D, int bs,
                                             int esize, int quant,
                                             int span) {
  return dap::split_smem(G, D, bs, esize, quant != 0, span);
}

// The int8 twin, on the split kernel: k/v (NB+1, bs, KH, D) int8 with
// per-block scale rows ks/vs (NB+1, KH, D) f32; KH x B x nsplit CTAs, split
// j owning table entries [j*span, (j+1)*span); part the f32 scratch of
// B * KH * nsplit * G * (D + 2) floats; tickets B * KH int32, zero (and
// zero again after the launch).  dtype (q, out): 0 = float32, 1 =
// bfloat16.
int lrk_decode_attention_paged_q(int dtype, const void* q, const void* k,
                                 const void* ks, const void* v,
                                 const void* vs, const void* bt,
                                 const void* cache_pos, void* out,
                                 void* part, void* tickets, int B, int nblk,
                                 int bs, int KH, int G, int D, int span,
                                 int nsplit, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dap::launch_split<float, int8_t, true>(
        q, k, ks, v, vs, bt, cache_pos, out, part, tickets, B, nblk, bs,
        nblk * bs, KH, G, D, span, nsplit, softcap, s);
  if (dtype == 1)
    return dap::launch_split<__nv_bfloat16, int8_t, true>(
        q, k, ks, v, vs, bt, cache_pos, out, part, tickets, B, nblk, bs,
        nblk * bs, KH, G, D, span, nsplit, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The earlier int8 kernel (one CTA per slot and KV head walking the whole
// table), kept for chip_smoke's prev_ms; same operands as
// lrk_decode_attention_paged.
int lrk_decode_attention_paged_q_prev(int dtype, const void* q,
                                      const void* k, const void* ks,
                                      const void* v, const void* vs,
                                      const void* bt, const void* cache_pos,
                                      void* out, int B, int nblk, int bs,
                                      int KH, int G, int D, float softcap,
                                      void* stream) {
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

// B5 on the split kernel: out (B,KH,G,D) = attention of q (B,KH,G,D) over
// the int8 slot pool kq/vq (B,S,KH,D) with one f32 scale row per slot and
// head, ks/vs (B,KH,D), at positions <= cache_pos (B,) int32; all
// contiguous.  Entries of SLOT_ENTRY positions (the last one ragged where
// S is not a multiple), KH x B x nsplit CTAs, split j owning entries
// [j*span, (j+1)*span); part the f32 scratch of B * KH * nsplit * G *
// (D + 2) floats; tickets B * KH int32, zero (and zero again after the
// launch).  dtype (q, out): 0 = float32, 1 = bfloat16.  Shared memory as
// lrk_decode_attention_paged_split_smem(G, D, SLOT_ENTRY, 1, 0, span).
int lrk_decode_attention_q(int dtype, const void* q, const void* kq,
                           const void* ks, const void* vq, const void* vs,
                           const void* cache_pos, void* out, void* part,
                           void* tickets, int B, int S, int KH, int G,
                           int D, int span, int nsplit, float softcap,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bs = dap::SLOT_ENTRY, nblk = (S + bs - 1) / bs;
  if (dtype == 0)
    return dap::launch_split<float, int8_t, false, true>(
        q, kq, ks, vq, vs, nullptr, cache_pos, out, part, tickets, B, nblk,
        bs, S, KH, G, D, span, nsplit, softcap, s);
  if (dtype == 1)
    return dap::launch_split<__nv_bfloat16, int8_t, false, true>(
        q, kq, ks, vq, vs, nullptr, cache_pos, out, part, tickets, B, nblk,
        bs, S, KH, G, D, span, nsplit, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
