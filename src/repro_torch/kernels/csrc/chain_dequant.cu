// The dequantizing pass of the quantized chains B3 (lowrank_matmul_q) and
// B4 (branched_matmul_q) (sm_90a):
//   out[g, k, n] = round_T( f32(q[g, k, n]) * scale[g, n] )
// for the factors of a call that its form reads dequantized: T f32 for the
// f32 form's factors whose rows are not whole 4-byte words (chain_f32.cu;
// the ResNets' fc rank 335), and T bf16 for the earlier large-M design of
// B3 / B4 (every factor into scratch, then B1 / B2's wgmma products), kept
// callable, uncounted, as the yardstick of the large-M form that now
// converts int8 / e4m3 tiles inside its pipeline (chain_wgmma.cuh).  The
// bits are those of the plain version's dequantization (kernels/ref.py::
// _dq) and of the TPU kernels', which dequantize to x's dtype in VMEM
// before each product (src/repro/kernels/lowrank_matmul_q.py:41-49,
// branched_matmul_q.py:48-50): int8 converts to f32 exactly, e4m3 goes
// through f16 (cvt.rn.f16x2.e4m3x2, exact) to f32, the product with the
// column's f32 scale rounds to nearest in f32, and bf16 rounds that to
// nearest even once.
//
// Why a pass for the fc's rows: the f32 form copies a quantized tile 16 or
// 4 bytes at a time, and a row of 335 bytes is neither; the pass writes it
// as f32 padded rows.  It costs 1 byte read and 4
// (f32) or 2 (bf16) written a weight value, into the scratch rows the plan
// lays out (kernels/branched_matmul.py::f32_plan, ::large_m_plan with
// dequant), zero past the row's end.
//
// Design: one launch for every factor of a call (up to 4 ops); a thread
// converts 16 columns of one row: one 16-byte load of values and four of
// scales where the row is whole 16-byte granules (byte loads otherwise),
// and 16-byte stores of the converted granules of the padded row.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dqc {

constexpr int COLS = 16;      // columns a thread converts
constexpr int THREADS = 256;  // threads of a block
constexpr int MAX_OPS = 4;    // factors of one launch

// One factor: `groups` x `rows` x `cols` values at q (row-major, rows of
// cols), scales (groups, cols) at scale, out (groups, rows, out_ld) of T;
// vec: rows and scales are read 16 bytes at a time; first: the block
// index the op starts at.
struct Op {
  const uint8_t* q;
  const float* scale;
  void* out;
  int groups, rows, cols, chunks, vec;
  long long out_ld, first;
};

struct Ops {
  Op op[MAX_OPS];
  int n;
};

template <typename Q>
__device__ __forceinline__ float to_f32(uint8_t b);
template <>
__device__ __forceinline__ float to_f32<int8_t>(uint8_t b) {
  return (float)(int8_t)b;
}
template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(uint8_t b) {
  // e4m3 -> f16 is exact, f16 -> f32 too
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      (__nv_fp8_storage_t)b, __NV_E4M3)));
}

// 16-byte granules of the converted values: 8 bf16 or 4 f32 a granule
template <typename T>
struct Out;
template <>
struct Out<__nv_bfloat16> {
  static constexpr int PER = 8;
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 r;
    uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return r;
  }
};
template <>
struct Out<float> {
  static constexpr int PER = 4;
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <typename Q, typename T>
__global__ void __launch_bounds__(THREADS) dq_rows_kernel(const Ops ops) {
  int i = 0;
  while (i + 1 < ops.n && blockIdx.x >= ops.op[i + 1].first) ++i;
  const Op& o = ops.op[i];
  const long long item =
      (blockIdx.x - o.first) * (long long)THREADS + threadIdx.x;
  const long long total = (long long)o.groups * o.rows * o.chunks;
  if (item >= total) return;
  const long long row = item / o.chunks;  // g * rows + k
  const int c0 = (int)(item % o.chunks) * COLS;
  const int g = (int)(row / o.rows);
  const uint8_t* src = o.q + row * o.cols + c0;
  const float* sc = o.scale + (long long)g * o.cols + c0;
  float v[COLS];
  if (o.vec) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < COLS; j += 4) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(sc + j));
      v[j] = __fmul_rn(to_f32<Q>(b[j]), s.x);
      v[j + 1] = __fmul_rn(to_f32<Q>(b[j + 1]), s.y);
      v[j + 2] = __fmul_rn(to_f32<Q>(b[j + 2]), s.z);
      v[j + 3] = __fmul_rn(to_f32<Q>(b[j + 3]), s.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      v[j] = c0 + j < o.cols ? __fmul_rn(to_f32<Q>(src[j]), __ldg(sc + j))
                             : 0.f;
  }
  constexpr int PER = Out<T>::PER;
  T* out = static_cast<T*>(o.out) + row * o.out_ld + c0;
#pragma unroll
  for (int j = 0; j < COLS; j += PER)
    if (c0 + j < o.out_ld)
      *reinterpret_cast<uint4*>(out + j) = Out<T>::pack(v + j);
}

template <typename Q, typename T>
int launch(Ops& ops, cudaStream_t stream) {
  long long blocks = 0;
  for (int i = 0; i < ops.n; ++i) {
    Op& o = ops.op[i];
    o.first = blocks;
    blocks += ((long long)o.groups * o.rows * o.chunks + THREADS - 1) /
              THREADS;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dq_rows_kernel<Q, T><<<(unsigned)blocks, THREADS, 0, stream>>>(ops);
  return (int)cudaGetLastError();
}

}  // namespace dqc

extern "C" {

// The dequantizing pass of one call: the n ops (n <= 4) of its plan
// (kernels/branched_matmul.py), one launch on `stream`.  Op i is the SPEC
// longs at spec + i * SPEC:
//   q, scale, out, groups, rows, cols, out_ld
// with q, scale, out slots of `ptrs` (the call's factors, their scales and
// scratch regions): out[(g*rows + k)*out_ld + n] = round(f32(q[(g*rows +
// k)*cols + n]) * scale[g*cols + n]) for n < cols, 0 for cols <= n <
// out_ld.  qdtype: 0 int8, 1 e4m3; out_dtype: 0 f32, 1 bf16.  out 16-byte
// aligned and out_ld whole 16-byte granules of out_dtype.  Returns the
// launch's cudaError_t (0 on success).
int lrk_dequant_rows(int n, const long long* spec, const void* const* ptrs,
                     int qdtype, int out_dtype, void* stream) {
  constexpr int SPEC = 7;
  if (n < 0 || n > dqc::MAX_OPS || qdtype < 0 || qdtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int per = out_dtype == 1 ? 8 : 4;
  dqc::Ops ops{};
  ops.n = n;
  for (int i = 0; i < n; ++i) {
    const long long* s = spec + (size_t)i * SPEC;
    dqc::Op& o = ops.op[i];
    o.q = static_cast<const uint8_t*>(ptrs[s[0]]);
    o.scale = static_cast<const float*>(ptrs[s[1]]);
    o.out = const_cast<void*>(ptrs[s[2]]);
    o.groups = (int)s[3];
    o.rows = (int)s[4];
    o.cols = (int)s[5];
    o.out_ld = s[6];
    if (o.groups <= 0 || o.rows <= 0 || o.cols <= 0 || o.out_ld < o.cols ||
        o.out_ld % per || reinterpret_cast<uintptr_t>(o.out) % 16)
      return (int)cudaErrorInvalidValue;
    o.chunks = (int)((o.out_ld + dqc::COLS - 1) / dqc::COLS);
    o.vec = o.cols % 16 == 0 && reinterpret_cast<uintptr_t>(o.q) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(o.scale) % 16 == 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qdtype == 0)
    return out_dtype == 1 ? dqc::launch<int8_t, __nv_bfloat16>(ops, st)
                          : dqc::launch<int8_t, float>(ops, st);
  return out_dtype == 1 ? dqc::launch<__nv_fp8_e4m3, __nv_bfloat16>(ops, st)
                        : dqc::launch<__nv_fp8_e4m3, float>(ops, st);
}

}  // extern "C"
