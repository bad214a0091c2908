// Absorbed-form MLA decode attention over an int8 latent slot pool
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention_q.py
// (decode_attention_latent_q, pl.pallas_call at :241, body _latent_kernel
// at :164).  There the grid is (B, S/bs): all H heads of a slot ride as
// the rows of one block, and the f32 context accumulator (H, L) and the
// online-softmax state are carried across the in-order sequence axis in
// VMEM scratch.  GPU blocks run in no order and a Hopper block holds at
// most 227 KB, a quarter of 128 heads' (H, L) accumulator.
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
// A live slot skips the positions past its cache_pos: their weights are
// exactly 0 (exp(-1e30 - m) underflows) in the plain version too.  An idle
// slot walks all of S.
//
// What bounds it on an H100: the operations.  All H heads share one latent
// stream, so every byte of ckv_q / krope_q feeds 2*H multiply-adds
// (2*B*H*S*(2L+R) FLOP against B*S*(L+R) bytes: about 1.7 GFLOP on 3.6 MB
// at the served shape, 8 slots of S = 1024, positions in [512, 1024),
// H = 128, L = 512, R = 64).  So the products run on the tensor cores, and
// the whole card works on one call:
//
//   * Grid (head tile, slot, split).  A head tile is MT m16 tiles (32
//     heads where L <= 512, else 16); a split owns `span` positions (a
//     whole number of stages), planned by latent_split in
//     kernels/decode_attention_latent_q.py at about one CTA per SM: 4
//     head tiles x 8 slots x 4 splits of 256 positions at the served
//     shape.  cache_pos stays on the card: a live slot's split that starts
//     past it writes an empty partial (m = -inf, l = 0) and takes its
//     ticket; an idle slot's splits walk their whole ranges under -1e30.
//   * 16 warps.  One CTA of ~219 kB fits an SM, so its own warps are all
//     the latency hiding there is; each phase below is spread over all of
//     them.
//   * Staging: one stage of BS positions (64; 32 or 16 where shared
//     memory asks) of raw int8 latents [ckv | krope] by 16-byte cp.async,
//     converted once per CTA into a bf16 tile Cb (BS, K) in shared memory
//     (int8 is exact in bf16; K = L + R rounded up to 16, zero past L + R
//     and past the stage's last position).  The next stage's copies are
//     in flight while this one's products run.
//   * Products on mma.sync.m16n8k16 bf16 -> f32 (the tile helpers of
//     mma_chain.cuh).  The folded query Q (f32) is split once into bf16
//     hi + lo = round(Q) + round(Q - round(Q)); logits S = hi.Cb^T +
//     lo.Cb^T (ldmatrix of Cb's rows), each warp a 16-head x 16-position
//     tile over one half of K, the halves added by the softmax; with Cb
//     exact the logits carry about 16 bits of the query's mantissa.
//     Online softmax per head row over the stage (f32, in shared memory),
//     then the weights P split the same way and O += P_hi.Cb + P_lo.Cb
//     (ldmatrix.trans of Cb), each warp holding a 16-row x 64-column
//     slice of O in registers.
//   * Fold, in the same launch: each split writes its f32 partial (O, m,
//     l) to a scratch the wrapper allocates; the last CTA of each (head
//     tile, slot) to take an atomic ticket sums them in split order,
//     out = (sum_j e^(m_j - M) O_j) / (sum_j e^(m_j - M) l_j) * ckv_scale,
//     and resets the ticket for the next launch.  The order is fixed, so
//     a second call gives the same bits.
// A stage is four phases behind barriers (convert, logits, softmax,
// context), each short enough that latency, not issue rate, sets its
// pace; the tensor cores run well below their rate.  Around the stages,
// the query fold, the partials' write and the fold cost about as much
// again at the served shape (PERF.md).
//
// The earlier design (namespace dal_prev: one CTA of 4 heads per (head
// group, slot) walking the slot's whole stream on f32 FMAs) stays
// callable uncounted as lrk_decode_attention_latent_q_prev, the yardstick
// chip_smoke times beside the new kernel (prev_ms).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_chain.cuh"

namespace dal {

using mmac::bf16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;           // bf16 padding of a shared row (16 B)
constexpr int SPAD = 8;          // f32 padding of a logit row (32 B)
constexpr int MAX_GROUPS = 4;    // 16-column context groups per warp
constexpr int MAX_SPLITS = 32;
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

// Eight consecutive values of a row, as f32: 16 bytes of bf16 or 32 of
// f32 (src 16-byte aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&f)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(words[i] << 16);
    f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* src, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 c = *reinterpret_cast<const float4*>(src + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
}

// Eight bf16 as one 16-byte word.
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 o;
  uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return o;
}

// Four outputs stored at once (dst aligned to their size).
__device__ __forceinline__ void store4(float* dst, const float4& v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float4& v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 c = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&c));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The logits' reduction depth: [ckv | krope] rounded up to 16.
__host__ __device__ inline int kdim(int L, int R) {
  return (L + R + 15) / 16 * 16;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Byte offsets of the shared regions of one CTA (each 16-byte aligned):
// the query's bf16 hi / lo rows (HT, K), the converted stage Cb (BS, K),
// the raw stage (BS x L ckv bytes, then BS x R krope bytes), the logits
// of the two K halves (2 x (HT, BS)) f32, the weights' hi / lo (HT, BS)
// bf16, the running max, sum and rescale per head row, the fold's
// coefficients (HT, MAX_SPLITS) and sums, and the last-CTA flag.
struct Layout {
  size_t qhi, qlo, cb, raw, s, phi, plo, m, l, a, coef, lsum, flag, total;
};

__host__ __device__ inline Layout layout(int L, int R, int BS, int MT) {
  const size_t K = kdim(L, R), HT = 16 * MT;
  Layout o;
  size_t at = 0;
  o.qhi = at;  at += align16(HT * (K + PAD) * 2);
  o.qlo = at;  at += align16(HT * (K + PAD) * 2);
  o.cb = at;   at += align16((size_t)BS * (K + PAD) * 2);
  o.raw = at;  at += align16((size_t)BS * (L + R));
  o.s = at;    at += 2 * align16(HT * (BS + SPAD) * 4);
  o.phi = at;  at += align16(HT * (BS + PAD) * 2);
  o.plo = at;  at += align16(HT * (BS + PAD) * 2);
  o.m = at;    at += align16(HT * 4);
  o.l = at;    at += align16(HT * 4);
  o.a = at;    at += align16(HT * 4);
  o.coef = at; at += align16(HT * MAX_SPLITS * 4);
  o.lsum = at; at += align16(HT * 4);
  o.flag = at; at += 16;
  o.total = at;
  return o;
}

// Whether the split kernel takes a geometry: L a multiple of 16 whose 16-
// column groups the warps of one m16 tile cover (at most MAX_GROUPS each),
// R a multiple of 4, BS 16, 32 or 64 positions, MT 1 or 2 m16 tiles, and
// the layout within the shared memory limit.
inline bool takes(int L, int R, int BS, int MT) {
  if (L < 16 || L % 16 || R < 4 || R % 4) return false;
  if (BS != 16 && BS != 32 && BS != 64) return false;
  if (MT != 1 && MT != 2) return false;
  if (L / 16 > MAX_GROUPS * (WARPS / MT)) return false;
  return layout(L, R, BS, MT).total <= (size_t)SMEM_LIMIT;
}

// `bytes` bytes from src to dst with cp.async: 16-byte copies where src
// and the length allow, else 4-byte copies (R a multiple of 4).
__device__ __forceinline__ void copy_span(unsigned char* dst,
                                          const unsigned char* src,
                                          int bytes, int tid) {
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes) & 15) == 0) {
    for (int i = 16 * tid; i < bytes; i += 16 * THREADS)
      mmac::cp_async16(dst + i, src + i);
  } else {
    for (int i = 4 * tid; i < bytes; i += 4 * THREADS)
      mmac::cp_async4(dst + i, src + i);
  }
}

// ql (B,H,L), qr (B,H,R) T; cq (B,S,L), rq (B,S,R) int8; cs (B,L),
// rs (B,R) f32 (ql, qr, cs, rs 16-byte aligned: read 8 values at a time);
// cache_pos (B,) int32; out (B,H,L) T.  part: the f32
// partials, O (B, tiles, splits, HT, L) then (m, l) (B, tiles, splits,
// HT, 2); tickets (B, tiles) int32, zero before the launch and left zero.
// Grid (tiles, B, splits); split j owns positions [j*span, (j+1)*span).
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 1)
split_kernel(const T* __restrict__ ql, const T* __restrict__ qr,
             const int8_t* __restrict__ cq, const float* __restrict__ cs,
             const int8_t* __restrict__ rq, const float* __restrict__ rs,
             const int* __restrict__ cache_pos, T* __restrict__ out,
             float* __restrict__ part, int* __restrict__ tickets, int S,
             int H, int L, int R, int BS, int span, float scale) {
  constexpr int HT = 16 * MT;
  constexpr int WPM = WARPS / MT;  // warps per m16 tile in the context
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(L, R, BS, MT);
  const int K = kdim(L, R);
  const int LDQ = K + PAD, LDS = BS + SPAD, LDP = BS + PAD;
  bf16* Qhi = reinterpret_cast<bf16*>(smem + lay.qhi);
  bf16* Qlo = reinterpret_cast<bf16*>(smem + lay.qlo);
  bf16* Cb = reinterpret_cast<bf16*>(smem + lay.cb);
  unsigned char* raw = smem + lay.raw;
  float* Ss = reinterpret_cast<float*>(smem + lay.s);  // the K halves' logits
  float* Ss1 = Ss + align16(HT * (BS + SPAD) * 4) / 4;
  bf16* Phi = reinterpret_cast<bf16*>(smem + lay.phi);
  bf16* Plo = reinterpret_cast<bf16*>(smem + lay.plo);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* a_s = reinterpret_cast<float*>(smem + lay.a);
  float* coef = reinterpret_cast<float*>(smem + lay.coef);
  float* lsum = reinterpret_cast<float*>(smem + lay.lsum);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);

  const int tile = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tiles = gridDim.x, nsplit = gridDim.z;
  const int h0 = tile * HT, hg = min(HT, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cp = cache_pos[b];
  const int n_valid = cp < 0 ? S : min(S, cp + 1);
  const int begin = split * span;
  const int end = min(n_valid, begin + span);
  const bool live = begin < end;
  const float* csb = cs + (size_t)b * L;
  const float* rsb = rs + (size_t)b * R;
  const unsigned char* cqb =
      reinterpret_cast<const unsigned char*>(cq + (size_t)b * S * L);
  const unsigned char* rqb =
      reinterpret_cast<const unsigned char*>(rq + (size_t)b * S * R);
  const size_t group = (size_t)b * tiles + tile;  // this (slot, head tile)
  float* Opart = part + (group * nsplit + split) * HT * L;
  float* MLbase = part + (size_t)gridDim.y * tiles * nsplit * HT * L;

  // This warp's context slice: m16 tile mi, 16-column groups cg0 + WPM*k.
  const int mi = warp % MT, cg0 = warp / MT, groups = L / 16;
  float acc[MAX_GROUPS][2][4];
#pragma unroll
  for (int k = 0; k < MAX_GROUPS; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][j][q] = 0.f;

  if (live) {
    // the first stage lands while the query rows are folded and split
    copy_span(raw, cqb + (size_t)begin * L, min(BS, S - begin) * L, tid);
    copy_span(raw + BS * L, rqb + (size_t)begin * R,
              min(BS, S - begin) * R, tid);
    mmac::cp_async_commit();
    // item = (head row, 8 columns): vector loads where the 8 columns lie
    // whole in q_lat (L a multiple of 16) or in q_rope (R a multiple of
    // 8), else masked scalar loads; hi and lo stored 16 bytes at a time
    const int items = HT * (K / 8);
    constexpr int QI = 4;  // items per thread with their loads in flight
    for (int it0 = tid; it0 < items; it0 += QI * THREADS) {
      float q[QI][8], sc[QI][8];
#pragma unroll
      for (int u = 0; u < QI; ++u) {
        const int it = it0 + u * THREADS;
        const int r = it / (K / 8), c0 = (it % (K / 8)) * 8;
        const size_t row = (size_t)b * H + h0 + r;
        if (it >= items || r >= hg || c0 >= L + R) {
#pragma unroll
          for (int x = 0; x < 8; ++x) q[u][x] = sc[u][x] = 0.f;
        } else if (c0 < L) {
          load8(ql + row * L + c0, q[u]);
          load8(csb + c0, sc[u]);
        } else if (R % 8 == 0) {
          load8(qr + row * R + (c0 - L), q[u]);
          load8(rsb + (c0 - L), sc[u]);
        } else {
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int c = c0 - L + x;
            q[u][x] = c < R ? to_f32(qr[row * R + c]) : 0.f;
            sc[u][x] = c < R ? rsb[c] : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < QI; ++u) {
        const int it = it0 + u * THREADS;
        if (it < items) {
          const int r = it / (K / 8), c0 = (it % (K / 8)) * 8;
          float hi[8], lo[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float v = q[u][x] * (sc[u][x] * scale);
            hi[x] = __bfloat162float(__float2bfloat16_rn(v));
            lo[x] = v - hi[x];
          }
          *reinterpret_cast<uint4*>(Qhi + r * LDQ + c0) = pack8(hi);
          *reinterpret_cast<uint4*>(Qlo + r * LDQ + c0) = pack8(lo);
        }
      }
    }
    if (tid < HT) {
      m_s[tid] = -INFINITY;
      l_s[tid] = 0.f;
    }

    for (int s0 = begin; s0 < end; s0 += BS) {
      const int npos = min(BS, S - s0);
      mmac::cp_async_wait<0>();
      __syncthreads();  // stage s0 landed; the last stage's products done
      // Cb row p = bf16([ckv | krope] of position s0 + p), zero past the
      // stage's positions and past L + R; 16 columns a chunk (L a multiple
      // of 16; a krope chunk reads 4-byte words, R a multiple of 4)
      {
        const int cpr = K / 16;  // chunks per row
#pragma unroll 3
        for (int e = tid; e < BS * cpr; e += THREADS) {
          const int p = e / cpr, c = (e % cpr) * 16;
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          if (p < npos) {
            if (c < L) {
              const uint4 v =
                  *reinterpret_cast<const uint4*>(raw + p * L + c);
              w[0] = v.x;
              w[1] = v.y;
              w[2] = v.z;
              w[3] = v.w;
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (c + 4 * i < L + R)
                  w[i] = *reinterpret_cast<const uint32_t*>(
                      raw + BS * L + p * R + (c - L) + 4 * i);
            }
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float f[8], f4[4];
            mmac::bytes_to_f32<int8_t>(w[2 * h2], f4);
            f[0] = f4[0]; f[1] = f4[1]; f[2] = f4[2]; f[3] = f4[3];
            mmac::bytes_to_f32<int8_t>(w[2 * h2 + 1], f4);
            f[4] = f4[0]; f[5] = f4[1]; f[6] = f4[2]; f[7] = f4[3];
            *reinterpret_cast<uint4*>(Cb + p * LDQ + c + 8 * h2) = pack8(f);
          }
        }
      }
      __syncthreads();  // Cb written; the raw stage free
      if (s0 + BS < end) {
        const int nnext = min(BS, S - s0 - BS);
        copy_span(raw, cqb + (size_t)(s0 + BS) * L, nnext * L, tid);
        copy_span(raw + BS * L, rqb + (size_t)(s0 + BS) * R, nnext * R,
                  tid);
      }
      mmac::cp_async_commit();

      // Logits: unit u = (m16 tile u % MT, positions 16*(u / MT % (BS /
      // 16)) .. +15, K half u / (MT * BS / 16)); each K half writes its
      // own buffer, the softmax adds the two.
      const int Kh = (K + 31) / 32 * 16;
      for (int u = warp; u < 2 * MT * (BS / 16); u += WARPS) {
        const int um = u % MT, un = (u / MT) % (BS / 16);
        const int kh = u / (MT * (BS / 16));
        float sacc[2][2][4];  // [hi / lo][n-tile]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) sacc[i][j][q] = 0.f;
        const int arow = (um * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8;
        const bf16* cb = Cb + (un * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  LDQ + ((lane >> 3) & 1) * 8;
        const int k_end = min(K, (kh + 1) * Kh);
#pragma unroll 4
        for (int k = kh * Kh; k < k_end; k += 16) {
          uint32_t ah[4], al[4], bb[4];
          mmac::ldmatrix_x4(ah, Qhi + arow + k);
          mmac::ldmatrix_x4(al, Qlo + arow + k);
          mmac::ldmatrix_x4(bb, cb + k);  // rows = positions: B as .col
          mmac::mma_bf16(sacc[0][0], ah, bb[0], bb[1]);
          mmac::mma_bf16(sacc[1][0], al, bb[0], bb[1]);
          mmac::mma_bf16(sacc[0][1], ah, bb[2], bb[3]);
          mmac::mma_bf16(sacc[1][1], al, bb[2], bb[3]);
        }
        float* sbuf = kh ? Ss1 : Ss;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* srow = sbuf + (um * 16 + g) * LDS + un * 16 + j * 8 + 2 * t;
          *reinterpret_cast<float2*>(srow) =
              make_float2(sacc[0][j][0] + sacc[1][j][0],
                          sacc[0][j][1] + sacc[1][j][1]);
          *reinterpret_cast<float2*>(srow + 8 * LDS) =
              make_float2(sacc[0][j][2] + sacc[1][j][2],
                          sacc[0][j][3] + sacc[1][j][3]);
        }
      }
      __syncthreads();

      // Online softmax, a warp per head row, the warp's RPW rows at once;
      // -inf marks a position past S (weight 0).  The weights go out as
      // bf16 hi / lo.
      {
        constexpr int RPW = HT / WARPS;
        float sv[RPW][2], mx[RPW], m_new[RPW], sum[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp + WARPS * i;
          mx[i] = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = lane + 32 * j;
            float sc = -INFINITY;
            if (p < npos)
              sc = s0 + p <= cp ? Ss[r * LDS + p] + Ss1[r * LDS + p] : NEG;
            sv[i][j] = sc;
            mx[i] = fmaxf(mx[i], sc);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp + WARPS * i;
          m_new[i] = fmaxf(m_s[r], mx[i]);
          sum[i] = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = lane + 32 * j;
            if (p < BS) {
              const float w =
                  sv[i][j] == -INFINITY ? 0.f : expf(sv[i][j] - m_new[i]);
              const bf16 hi = __float2bfloat16_rn(w);
              Phi[r * LDP + p] = hi;
              Plo[r * LDP + p] =
                  __float2bfloat16_rn(w - __bfloat162float(hi));
              sum[i] += w;
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int r = warp + WARPS * i;
            const float alpha = expf(m_s[r] - m_new[i]);
            a_s[r] = alpha;
            l_s[r] = l_s[r] * alpha + sum[i];
            m_s[r] = m_new[i];
          }
        }
      }
      __syncthreads();

      // Context: O = O * alpha + P_hi . Cb + P_lo . Cb over this warp's
      // column groups.
      const float a0 = a_s[mi * 16 + g], a1 = a_s[mi * 16 + g + 8];
#pragma unroll
      for (int k = 0; k < MAX_GROUPS; ++k)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[k][j][0] *= a0;
          acc[k][j][1] *= a0;
          acc[k][j][2] *= a1;
          acc[k][j][3] *= a1;
        }
      const int prow = (mi * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
      for (int kk = 0; kk < BS; kk += 16) {
        uint32_t ph[4], pl[4];
        mmac::ldmatrix_x4(ph, Phi + prow + kk);
        mmac::ldmatrix_x4(pl, Plo + prow + kk);
        const bf16* cb = Cb + (kk + (lane & 15)) * LDQ + (lane >> 4) * 8;
#pragma unroll
        for (int k = 0; k < MAX_GROUPS; ++k) {
          const int cg = cg0 + WPM * k;
          if (cg < groups) {
            uint32_t bb[4];
            mmac::ldmatrix_x4_trans(bb, cb + cg * 16);
            mmac::mma_bf16(acc[k][0], ph, bb[0], bb[1]);
            mmac::mma_bf16(acc[k][0], pl, bb[0], bb[1]);
            mmac::mma_bf16(acc[k][1], ph, bb[2], bb[3]);
            mmac::mma_bf16(acc[k][1], pl, bb[2], bb[3]);
          }
        }
      }
    }

    // this split's partial: O (rows of the whole tile), then m, l
#pragma unroll
    for (int k = 0; k < MAX_GROUPS; ++k) {
      const int cg = cg0 + WPM * k;
      if (cg < groups) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* orow = Opart + (size_t)(mi * 16 + g) * L + cg * 16 + j * 8 +
                        2 * t;
          *reinterpret_cast<float2*>(orow) =
              make_float2(acc[k][j][0], acc[k][j][1]);
          *reinterpret_cast<float2*>(orow + 8 * L) =
              make_float2(acc[k][j][2], acc[k][j][3]);
        }
      }
    }
  }
  if (tid < HT) {
    float* ml = MLbase + ((group * nsplit + split) * HT + tid) * 2;
    ml[0] = live ? m_s[tid] : -INFINITY;
    ml[1] = live ? l_s[tid] : 0.f;
  }

  // The last CTA of this (slot, head tile) to finish folds the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + group, 1) == nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* ml0 = MLbase + group * nsplit * HT * 2;
  for (int r = warp; r < HT; r += WARPS) {
    // lane j holds split j's (m, l); the max is exact in any order, the
    // sum of e^(m_j - M) l_j is taken in split order
    float mj = -INFINITY, lj = 0.f;
    if (lane < nsplit) {
      const float2 v = __ldcg(
          reinterpret_cast<const float2*>(ml0 + ((size_t)lane * HT + r) * 2));
      mj = v.x;
      lj = v.y;
    }
    const float M = warp_max(mj);
    const float cj = mj == -INFINITY ? 0.f : expf(mj - M);
    const float pj = cj * lj;
    float Ls = 0.f;
    for (int j = 0; j < nsplit; ++j) Ls += __shfl_sync(0xffffffffu, pj, j);
    if (lane < nsplit) coef[r * MAX_SPLITS + lane] = cj;
    if (lane == 0) lsum[r] = Ls;
  }
  __syncthreads();
  const float* O0 = part + group * nsplit * HT * L;
  const int L4 = L / 4;
  constexpr int FI = 4, FJ = 4;  // items x splits of loads in flight
  for (int base = tid; base < hg * L4; base += FI * THREADS) {
    float4 o[FI], sc[FI];
#pragma unroll
    for (int u = 0; u < FI; ++u) {
      o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int e = min(base + u * THREADS, hg * L4 - 1);
      sc[u] = *reinterpret_cast<const float4*>(csb + 4 * (e % L4));
    }
    for (int j0 = 0; j0 < nsplit; j0 += FJ) {
      float4 v[FJ][FI];
      float cj[FJ][FI];
#pragma unroll
      for (int jj = 0; jj < FJ; ++jj)
#pragma unroll
        for (int u = 0; u < FI; ++u) {
          const int j = min(j0 + jj, nsplit - 1);
          const int e = min(base + u * THREADS, hg * L4 - 1);
          const int r = e / L4, c = 4 * (e % L4);
          cj[jj][u] = j0 + jj < nsplit ? coef[r * MAX_SPLITS + j] : 0.f;
          v[jj][u] = __ldcg(reinterpret_cast<const float4*>(
              O0 + ((size_t)j * HT + r) * L + c));
        }
      // in split order; an empty split's O was never written, and its
      // coefficient is 0
#pragma unroll
      for (int jj = 0; jj < FJ; ++jj)
#pragma unroll
        for (int u = 0; u < FI; ++u)
          if (cj[jj][u] != 0.f) {
            o[u].x += cj[jj][u] * v[jj][u].x;
            o[u].y += cj[jj][u] * v[jj][u].y;
            o[u].z += cj[jj][u] * v[jj][u].z;
            o[u].w += cj[jj][u] * v[jj][u].w;
          }
    }
#pragma unroll
    for (int u = 0; u < FI; ++u) {
      const int e = base + u * THREADS;
      if (e < hg * L4) {
        const int r = e / L4, c = 4 * (e % L4);
        const float ls = lsum[r];
        store4(out + ((size_t)b * H + h0 + r) * L + c,
               make_float4(o[u].x / ls * sc[u].x, o[u].y / ls * sc[u].y,
                           o[u].z / ls * sc[u].z, o[u].w / ls * sc[u].w));
      }
    }
  }
  if (tid == 0) tickets[group] = 0;
}

template <typename T, int MT>
int launch(const void* ql, const void* qr, const void* cq, const void* cs,
           const void* rq, const void* rs, const void* cache_pos, void* out,
           void* part, void* tickets, int B, int S, int H, int L, int R,
           int BS, int span, int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = layout(L, R, BS, MT).total;
  const auto kernel = split_kernel<T, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((H + 16 * MT - 1) / (16 * MT), B, nsplit), THREADS, smem,
           stream>>>(
      static_cast<const T*>(ql), static_cast<const T*>(qr),
      static_cast<const int8_t*>(cq), static_cast<const float*>(cs),
      static_cast<const int8_t*>(rq), static_cast<const float*>(rs),
      static_cast<const int*>(cache_pos), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), S, H, L, R, BS,
      span, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mt(int MT, const void* ql, const void* qr, const void* cq,
              const void* cs, const void* rq, const void* rs,
              const void* cache_pos, void* out, void* part, void* tickets,
              int B, int S, int H, int L, int R, int BS, int span,
              int nsplit, float scale, cudaStream_t stream) {
  if (MT == 1)
    return launch<T, 1>(ql, qr, cq, cs, rq, rs, cache_pos, out, part,
                        tickets, B, S, H, L, R, BS, span, nsplit, scale,
                        stream);
  return launch<T, 2>(ql, qr, cq, cs, rq, rs, cache_pos, out, part, tickets,
                      B, S, H, L, R, BS, span, nsplit, scale, stream);
}

}  // namespace dal

// The earlier design, kept for chip_smoke's prev_ms: one CTA per (group
// of HG heads, slot) walks the slot's whole latent stream on f32 FMAs,
// bytes unpacked by shifts, blocks of 64 positions double-buffered with
// 4-byte cp.async.
namespace dal_prev {

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

}  // namespace dal_prev

extern "C" {

// Dynamic shared memory of one split-kernel launch (bytes) at latent width
// L, rope width R, BS positions per stage and MT m16 tiles of heads per
// CTA; 0 if the kernel does not take the geometry (see dal::takes).
size_t lrk_decode_attention_latent_q_smem(int L, int R, int BS, int MT) {
  return dal::takes(L, R, BS, MT) ? dal::layout(L, R, BS, MT).total : 0;
}

// out (B,H,L) = absorbed-form attention of q_lat (B,H,L) / q_rope (B,H,R)
// over the int8 latent pool ckv_q (B,S,L) / krope_q (B,S,R) with
// per-(slot, channel) scales ckv_scale (B,L) / krope_scale (B,R) f32 and
// positions <= cache_pos (B,) int32, logit scale `scale`; all contiguous.
// The split kernel: ceil(H / 16MT) head tiles x B slots x nsplit splits of
// `span` positions (a multiple of BS) each; part the f32 scratch of
// B * tiles * nsplit * 16MT * (L + 2) floats; tickets B * tiles int32, zero
// (and zero again after the launch).  dtype: 0 = float32, 1 = bfloat16
// (q_lat, q_rope, out).  Returns the launch's cudaError_t (0 on success).
int lrk_decode_attention_latent_q(int dtype, const void* ql, const void* qr,
                                  const void* cq, const void* cs,
                                  const void* rq, const void* rs,
                                  const void* cache_pos, void* out,
                                  void* part, void* tickets, int B, int S,
                                  int H, int L, int R, int MT, int BS,
                                  int span, int nsplit, float scale,
                                  void* stream) {
  if (S < 1 || !dal::takes(L, R, BS, MT) || span < BS || span % BS ||
      nsplit < 1 || nsplit > dal::MAX_SPLITS ||
      (long long)(nsplit - 1) * span >= S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dal::launch_mt<float>(MT, ql, qr, cq, cs, rq, rs, cache_pos, out,
                                 part, tickets, B, S, H, L, R, BS, span,
                                 nsplit, scale, s);
  if (dtype == 1)
    return dal::launch_mt<__nv_bfloat16>(MT, ql, qr, cq, cs, rq, rs,
                                         cache_pos, out, part, tickets, B, S,
                                         H, L, R, BS, span, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one launch of the earlier kernel at HG heads
// per CTA; 0 if it does not take the geometry (see dal_prev::takes).
size_t lrk_decode_attention_latent_q_prev_smem(int L, int R, int HG) {
  return dal_prev::takes(L, R, HG) ? dal_prev::smem_bytes(L, R, HG) : 0;
}

// The earlier kernel on the same operands, HG heads per CTA.
int lrk_decode_attention_latent_q_prev(int dtype, const void* ql,
                                       const void* qr, const void* cq,
                                       const void* cs, const void* rq,
                                       const void* rs, const void* cache_pos,
                                       void* out, int B, int S, int H, int L,
                                       int R, int HG, float scale,
                                       void* stream) {
  if (S < 1 || !dal_prev::takes(L, R, HG)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dal_prev::launch<float>(ql, qr, cq, cs, rq, rs, cache_pos, out, B,
                                   S, H, L, R, HG, scale, s);
  if (dtype == 1)
    return dal_prev::launch<__nv_bfloat16>(ql, qr, cq, cs, rq, rs, cache_pos,
                                           out, B, S, H, L, R, HG, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
