// The f32 form of the chain kernels (sm_90a): B1
//   y = (x @ w0) @ w1                                       (lowrank_matmul)
// and B2
//   y = sum_n ((x @ u_n) @ xc_n) @ v_n                      (branched_matmul)
// with f32 activations and factors, held to 1e-4 of the plain versions
// (max |kernel - plain| / max |plain|), at every M: a decode step's 8 rows,
// the ResNets' fc at 1 / 32, hubert's 500 frames, the VLM's 1,601 image
// tokens.
//
// Replaces, for f32, the TPU kernels src/repro/kernels/lowrank_matmul.py::
// lowrank_matmul (pallas_call at :68) and src/repro/kernels/
// branched_matmul.py::branched_matmul (:69).  In f32 their casts are the
// identity, so only the f32 sums are kept: h (B1), h1 and h2 (B2) are f32,
// and B2's branch sum is taken in f32 inside y's one reduction.
//
// What bounds it on an H100: at decode the weight bytes (M = 8 does 4
// operations per f32 weight byte: the VLM's gate,up chain reads 463 MB,
// 0.138 ms at 3.35 TB/s); from M ~ 50 on, the operations.  The earlier f32
// kernel (the 8-CTA cluster kernel of lrk_common.cuh) kept each branch's
// h1 / h2 whole in shared memory, so at the VLM's ranks 768 / 960 it took
// 4-row blocks, read every weight once per block from at most 16 SMs, and
// multiplied on CUDA-core FMAs: 14-29x the cuBLAS chain.
//
// Design: every product of the chain is one launch of f32_gemm_kernel, an
// output-tiled GEMM over the whole card, in order on the current stream
// (kernels/branched_matmul.py::f32_plan):
//   B1: h = x @ w0 into an (M, R) f32 scratch; y = h @ w1;
//   B2: h1[:, n] = x @ u_n (one tile space over the N*r1 columns, the
//       tile's branch picks u_n); h2[:, n] = h1_n @ xc_n (N grouped
//       products); y = h2 @ v, with h2 laid out (M, N*r2) and v read as one
//       (N*r2, S) matrix, so the branch sum is the K loop.
// A CTA owns a BM x 128 output tile (BM 16, 32 or 64 by M: a decode step's
// 8 rows do not pay for 64) over one K slice; the row tiles of a column
// tile are neighbours in the grid, so its B is read from device memory
// once and from L2 by the others.  Where a product's tiles do not fill the
// card (two CTAs an SM), its K is cut into slices so that it has about two
// work items per SM: at M = 8 the VLM's first gate,up product has 24 tiles
// over K = 8,192 and runs as 11 slices of 768.  Each CTA streams its A
// (BM x 32) and B (32 x 128) tiles through a 4-stage ring of 16-byte
// cp.async copies (4-byte copies for an operand whose base or strides are
// not whole 16-byte granules: the ResNets' fc rank 335), zero-filled past
// every edge.  A sliced tile's CTAs store their f32 partials in scratch;
// the last of them to take its tile's ticket (kernels/build.py::tickets)
// adds the partials in slice order, 0 first, 4 columns a thread, and
// stores the tile; the ticket goes back to 0.  No atomics touch a value,
// so two calls give the same bits.
//
// The arithmetic: split TF32 (3xTF32) on mma.sync.m16n8k8.tf32.  Each
// operand value a becomes hi = tf32(a) (cvt.rna) and lo = tf32(a - hi), and
// a tile accumulates lo*hi + hi*lo + hi*hi, dropping only lo*lo (2^-22 of
// a product).  Plain TF32 keeps 11 significant bits and misses 1e-4; split
// TF32 holds about f32's precision at three tensor-core products a term:
// up to 495 / 3 = 165 TFLOP/s of f32 work, the peak the f32 rows' bound
// uses, against 67 on CUDA-core FMAs.  The tensor cores truncate as they
// accumulate, so a sum carried through thousands of mma's drifts (at the
// VLM's K, by a good part of the 1e-4): each ring stage's 12 mma's
// start from zero and the stage's sum is added to the tile's in f32
// registers, rounded to nearest.
//
// Why mma.sync and not wgmma: PTX's wgmma takes the transposed (MN-major)
// B layout only for f16 / bf16; tf32 wgmma wants B K-major.  The factors
// are stored (K, N) row-major, N contiguous, so wgmma would need a
// transposed copy of every weight (or one per call).  mma.sync's fragments
// are read from padded shared tiles with 32- and 64-bit loads (ldmatrix is
// a 16-bit instruction), conflict-free (f32_gemm_kernel's note).
#include <cuda_runtime.h>
#include <stdint.h>

namespace f32c {

constexpr int BK = 32;          // K depth of a ring stage (128 B of f32)
constexpr int BN = 128;         // output tile width
constexpr int A_LD = BK + 8;    // shared row of the A tile (floats)
constexpr int B_LD = BN + 4;    // shared row of the B tile (floats)

constexpr int STAGES = 4;       // ring depth (two CTAs an SM)

// A tile of BM rows (16, 32 or 64): warps along M (WM) and N (WN), each
// owning a (BM / WM) x (BN / WN) block of MI x NI mma tiles of 16 x 8
template <int BM>
struct Tile {
  static constexpr int WM = BM == 16 ? 1 : 2, WN = 4;
  static constexpr int MI = BM / (16 * WM), NI = BN / (8 * WN);
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int STAGE = BM * A_LD + BK * B_LD;  // floats
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(float);
};
static_assert((A_LD * 4) % 16 == 0 && (B_LD * 4) % 16 == 0 &&
                  (Tile<16>::STAGE * 4) % 16 == 0,
              "every shared row and stage starts on a 16-byte granule");
static_assert(2 * (Tile<64>::SMEM + 1024) <= 228 * 1024,
              "two CTAs of the tallest tile share an SM");

// One product: c[z*c_group + m*c_ld + n] = sum_{k < K} A_z[m, k] B_z[k, n]
// for z < groups (gridDim.z / slices), m < M, n < N, with A_z[m, k] =
// a[z*a_group + m*a_ld + k] (a_group 0: one A for every group) and B_z[k, n]
// = b[z*b_group + k*b_ld + n].  K slice q covers [q*ks, min(K, q*ks + ks)).
struct Gemm {
  const float* a;
  long long a_ld, a_group;
  const float* b;
  long long b_ld, b_group;
  float* c;
  long long c_ld, c_group;
  float* p;       // partials (slices, groups, M, p_ld), where slices > 1
  int* tickets;   // one zeroed ticket per output tile, where slices > 1
  int M, N, K, ks, slices, p_ld, a_vec, b_vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, of which the first `bytes` come from src
// and the rest are zeros (src-size; 0 reads nothing)
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// one float, or a zero where `bytes` is 0
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo, each a tf32 rounded to nearest, ties away from zero: the
// bits of cvt.rna.tf32.f32, from full-rate integer adds and masks.  A
// non-finite a gives a NaN lo (inf - inf): a non-finite input makes the
// output NaN where the plain version may give +-inf.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d = A (16 x 8, row) @ B (8 x 8, col) + (acc ? d : 0), tf32 in, f32 sum
template <bool ACC>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (ACC)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        "\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]), "f"(0.f));
}

// rows [0, BM) x columns [0, BK) of A from row m0, column k0 (kv of them
// valid) into a shared tile; 16-byte copies where g.a_vec, else 4-byte
template <int BM, int T>
__device__ __forceinline__ void load_a(float* s, const Gemm& g,
                                       const float* A, int m0, int k0,
                                       int kv) {
  if (g.a_vec) {
    constexpr int GRANULES = BM * (BK / 4);
#pragma unroll
    for (int pass = 0; pass < (GRANULES + T - 1) / T; ++pass) {
      const int i = threadIdx.x + pass * T;
      if (GRANULES % T && i >= GRANULES) break;
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4, row = m0 + r;
      const int bytes = row < g.M ? 4 * max(0, min(4, kv - c)) : 0;
      cp16(s + r * A_LD + c, bytes ? A + row * g.a_ld + k0 + c : g.a, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += T) {
      const int r = i / BK, c = i % BK, row = m0 + r;
      const bool in = row < g.M && c < kv;
      cp4(s + r * A_LD + c, in ? A + row * g.a_ld + k0 + c : g.a,
          in ? 4 : 0);
    }
  }
}

// rows [0, BK) x columns [0, BN) of B from row k0 (kv valid), column n0
template <int T>
__device__ __forceinline__ void load_b(float* s, const Gemm& g,
                                       const float* B, int n0, int k0,
                                       int kv) {
  if (g.b_vec) {
    constexpr int GRANULES = BK * (BN / 4);
#pragma unroll
    for (int pass = 0; pass < (GRANULES + T - 1) / T; ++pass) {
      const int i = threadIdx.x + pass * T;
      if (GRANULES % T && i >= GRANULES) break;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4, col = n0 + c;
      const int bytes = r < kv ? 4 * max(0, min(4, g.N - col)) : 0;
      cp16(s + r * B_LD + c, bytes ? B + (k0 + r) * g.b_ld + col : g.b,
           bytes);
    }
  } else {
    for (int i = threadIdx.x; i < BK * BN; i += T) {
      const int r = i / BN, c = i % BN, col = n0 + c;
      const bool in = r < kv && col < g.N;
      cp4(s + r * B_LD + c, in ? B + (k0 + r) * g.b_ld + col : g.b,
          in ? 4 : 0);
    }
  }
}

// The last CTA of a sliced tile: y = sum over slices, in slice order, of
// the partials (every one, its own included, read back from device
// memory), stored to c.  A thread sums ITEMS runs of 4 columns; it loads
// two slices of all of them at once, so a tile of S slices costs about
// S / 2 round trips to L2.
template <int BM, int T>
__device__ __forceinline__ void fold(const Gemm& g, int z, int groups,
                                     int m0, int n0) {
  constexpr int ITEMS = BM * (BN / 4) / T;
  static_assert(BM * (BN / 4) % T == 0, "whole runs a thread");
  const long long plane = (long long)g.M * g.p_ld;
  const long long step = (long long)groups * plane;
  const float* base = g.p + z * plane;
  long long off[ITEMS];
  bool in[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * T;
    const int row = m0 + i / (BN / 4), col = n0 + (i % (BN / 4)) * 4;
    in[it] = row < g.M && col < g.N;
    off[it] = in[it] ? (long long)row * g.p_ld + col : 0;
  }
  float4 sum[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
    sum[it] = __ldcg(reinterpret_cast<const float4*>(base + off[it]));
  int s = 1;
  for (; s + 2 <= g.slices; s += 2) {
    float4 v[2][ITEMS];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int it = 0; it < ITEMS; ++it)
        v[u][it] = __ldcg(reinterpret_cast<const float4*>(
            base + (s + u) * step + off[it]));
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        sum[it].x += v[u][it].x;
        sum[it].y += v[u][it].y;
        sum[it].z += v[u][it].z;
        sum[it].w += v[u][it].w;
      }
  }
  if (s < g.slices) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          base + s * step + off[it]));
      sum[it].x += v.x;
      sum[it].y += v.y;
      sum[it].z += v.z;
      sum[it].w += v.w;
    }
  }
  float* out = g.c + z * g.c_group;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (!in[it]) continue;
    const int i = threadIdx.x + it * T;
    const int row = m0 + i / (BN / 4), col = n0 + (i % (BN / 4)) * 4;
    float* o = out + (long long)row * g.c_ld + col;
    const float vals[4] = {sum[it].x, sum[it].y, sum[it].z, sum[it].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < g.N) o[e] = vals[e];
  }
}

// One BM x BN output tile (blockIdx.x: row tile, the fastest, so the row
// tiles of a column tile read its B together; blockIdx.y: column tile) of
// group z over K slice q (blockIdx.z = z * slices + q).
//
// In each k8 step the mma's logical k = tig and tig + 4 are the shared
// tiles' physical columns (A) and rows (B) 2 tig and 2 tig + 1: a sum over
// k in any order, which lets a thread read its A pair as one 64-bit load.
// With A_LD = 40 the eight lanes of a row group hit eight different 8-word
// bank groups (64-bit loads, per half warp), and with B_LD = 132 the B
// fragment's 32 words (rows 2 tig, columns group) 32 different banks.
template <int BM>
__global__ void __launch_bounds__(Tile<BM>::THREADS, 2)
f32_gemm_kernel(const Gemm g) {
  using TL = Tile<BM>;
  constexpr int T = TL::THREADS, WN = TL::WN, MI = TL::MI, NI = TL::NI;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int wr = (warp / WN) * MI * 16, wc = (warp % WN) * NI * 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int z = blockIdx.z / g.slices, q = blockIdx.z % g.slices;
  const int k_begin = q * g.ks, k_end = min(g.K, k_begin + g.ks);
  const int chunks = (k_end - k_begin + BK - 1) / BK;
  const float* A = g.a + z * g.a_group;
  const float* B = g.b + z * g.b_group;

  auto load = [&](int stage, int chunk) {
    float* s = smem + stage * TL::STAGE;
    const int k0 = k_begin + chunk * BK, kv = min(BK, k_end - k0);
    load_a<BM, T>(s, g, A, m0, k0, kv);
    load_b<T>(s + BM * A_LD, g, B, n0, k0, kv);
  };

  // acc: the tile's sum over the slice, added stage by stage in f32 (round
  // to nearest); part: one stage's sum inside the tensor cores, which
  // truncate as they accumulate, so it starts from zero every stage
  float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_commit();
  }
  for (int it = 0; it < chunks; ++it) {
    // chunk it has landed, and every warp is done with the stage the
    // next load overwrites (the one multiplied at it - 1)
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < chunks)
      load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_commit();
    const float* sa = smem + (it % STAGES) * TL::STAGE;
    const float* sb = sa + BM * A_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* p = sa + (wr + i * 16 + grp) * A_LD + kk + 2 * tig;
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8 * A_LD);
        split(lo.x, ah[i][0], al[i][0]);
        split(hi.x, ah[i][1], al[i][1]);
        split(lo.y, ah[i][2], al[i][2]);
        split(hi.y, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float* p = sb + (kk + 2 * tig) * B_LD + wc + j * 8 + grp;
        split(p[0], bh[j][0], bl[j][0]);
        split(p[B_LD], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          if (kk == 0)
            mma<false>(part[i][j], al[i], bh[j]);
          else
            mma<true>(part[i][j], al[i], bh[j]);
          mma<true>(part[i][j], ah[i], bl[j]);
          mma<true>(part[i][j], ah[i], bh[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_wait<0>();

  // accumulator e of mma tile (i, j) is row wr + 16 i + grp + 8 (e / 2),
  // column wc + 8 j + 2 tig + e % 2 of the CTA's tile
  float* out = g.slices > 1
                   ? g.p + ((long long)q * (gridDim.z / g.slices) + z) *
                               g.M * g.p_ld
                   : g.c + z * g.c_group;
  const long long ld = g.slices > 1 ? g.p_ld : g.c_ld;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wr + i * 16 + grp + 8 * (e / 2);
        const int col = n0 + wc + j * 8 + 2 * tig + e % 2;
        if (row < g.M && col < g.N)
          out[(long long)row * ld + col] = acc[i][j][e];
      }
  if (g.slices == 1) return;

  // a sliced tile: the last of its CTAs to take the ticket sums it
  __threadfence();
  __syncthreads();
  const int tile = (z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last = atomicAdd(&g.tickets[tile], 1) == g.slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold<BM, T>(g, z, gridDim.z / g.slices, m0, n0);
  if (threadIdx.x == 0) g.tickets[tile] = 0;
}

inline bool granular(const void* p, long long ld, long long group) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 &&
         group % 4 == 0;
}

template <int BM>
int launch(const Gemm& g, int groups, cudaStream_t stream) {
  using TL = Tile<BM>;
  auto kernel = f32_gemm_kernel<BM>;
  // the ring's shared memory, opted into once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TL::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted |= 1ull << dev;
  }
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN,
                  groups * g.slices);
  kernel<<<grid, TL::THREADS, TL::SMEM, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace f32c

extern "C" {

// One call of the f32 form: the n products of its plan
// (kernels/branched_matmul.py::f32_plan), launched in order on `stream`.
// Product i is the SPEC longs at spec + i * SPEC:
//   a, a_ld, a_group, b, b_ld, b_group, c, c_ld, c_group, M, N, K,
//   groups, bm, ks, p, p_ld
// with a, b, c, p slots of `ptrs` (the call's x, factors, y and scratch
// regions; p -1 where the product has one K slice) and computes, for z <
// groups, c[z*c_group + m*c_ld + n] = sum_{k < K} a[z*a_group + m*a_ld + k]
// * b[z*b_group + k*b_ld + n], f32, in ceil(K / ks) K slices of ks (a
// multiple of 32) on bm (16, 32, 64) x 128 tiles; a sliced product's
// partials are (slices, groups, M, p_ld) at p.
// `tickets`: n_tickets zeroed int32, one per output tile of a sliced
// product, left zero.  Returns the first failing launch's cudaError_t.
int lrk_chain_f32(int n, const long long* spec, const void* const* ptrs,
                  void* tickets, int n_tickets, void* stream) {
  constexpr int SPEC = 17;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const long long* s = spec + (size_t)i * SPEC;
    f32c::Gemm g;
    g.a = static_cast<const float*>(ptrs[s[0]]);
    g.a_ld = s[1];
    g.a_group = s[2];
    g.b = static_cast<const float*>(ptrs[s[3]]);
    g.b_ld = s[4];
    g.b_group = s[5];
    g.c = static_cast<float*>(const_cast<void*>(ptrs[s[6]]));
    g.c_ld = s[7];
    g.c_group = s[8];
    g.M = (int)s[9];
    g.N = (int)s[10];
    g.K = (int)s[11];
    const int groups = (int)s[12], bm = (int)s[13];
    g.ks = (int)s[14];
    if (g.M <= 0 || g.N <= 0 || g.K <= 0 || groups <= 0 || g.ks <= 0 ||
        g.ks % f32c::BK)
      return (int)cudaErrorInvalidValue;
    g.slices = (g.K + g.ks - 1) / g.ks;
    g.p = s[15] < 0 ? nullptr
                    : static_cast<float*>(const_cast<void*>(ptrs[s[15]]));
    g.p_ld = (int)s[16];
    g.tickets = static_cast<int*>(tickets);
    const long long tiles = (long long)groups * ((g.M + bm - 1) / bm) *
                            ((g.N + f32c::BN - 1) / f32c::BN);
    if (g.slices > 1 &&
        (g.p == nullptr || g.tickets == nullptr || tiles > n_tickets ||
         g.p_ld < g.N || g.p_ld % 4 ||
         reinterpret_cast<uintptr_t>(g.p) % 16))
      return (int)cudaErrorInvalidValue;
    g.a_vec = f32c::granular(g.a, g.a_ld, g.a_group);
    g.b_vec = f32c::granular(g.b, g.b_ld, g.b_group);
    int rc = (int)cudaErrorInvalidValue;
    if (bm == 16) rc = f32c::launch<16>(g, groups, st);
    if (bm == 32) rc = f32c::launch<32>(g, groups, st);
    if (bm == 64) rc = f32c::launch<64>(g, groups, st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
