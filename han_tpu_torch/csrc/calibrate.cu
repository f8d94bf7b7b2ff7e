// Calibration kernels for Hopper (sm_90a): R dependency-chained passes of a
// primitive or of the flash kernels' inner bodies over data held on chip, so
// the marginal time per pass (R -> 2R, ops/calibrate.py:time_marginal) is
// the card's compute rate for that body, with no device-memory traffic in
// the timed loop. Plain C interface, bound with ctypes by
// han_tpu_torch/ops/calibrate.py, which also holds the plain PyTorch
// version of each kernel.
//
// Replaces (scripts/cal_vpu.py, which timed one TPU core's VPU on a
// (512, 2048) strip in VMEM):
//   prim_kernel<OP, T>      <- _prim_kernel (l.63) with _prim_body (l.35-60)
//   fwd_strip_kernel<MXU>   <- _fwd_strip_kernel (l.74)
//   fwd_strip_bf16_kernel   <- _fwd_strip_kernel_bf16 (l.112)
//   bwd_strip_kernel        <- _bwd_strip_kernel (l.144)
//
// The unit of work is the whole card: n_strips independent 128x128 strips
// (the port's flash tile, graph/bcsr.py), one thread block each for the
// strip bodies, or rows of 128 elements, 4 rows a warp, for the primitives;
// a launch fills all 132 SMs. Each block loads its slice once and keeps it
// in registers (primitives, carries, accumulators) and shared memory (the
// adjacency, ls, v, g) for all R passes. Inputs per strip s: ld, ls f32
// [8][128] (row 0 used, as cal_vpu.py uses ld_ref[0]), adj int8 [128][128]
// (every row holds an edge: see ops/calibrate.py), v [128][8], g f32
// [128][8].
//
// What bounds each on the H100 (the ceilings cal_vpu_torch.py holds every
// rate to, from the card's SM count and maximum SM clock; at 132 SMs and
// 1.98 GHz):
// - prim add, mul, lrelu, select, rowmax, rowsum: the FP32 lanes, 128 per
//   SM: 132 x 128 x clock = 3.35e13 simple f32 ops/s, and so at most
//   3.35e13 elements/s for a pass that needs one instruction an element
//   (scalar bf16 instructions issue on the same lanes; packed bf16x2 could
//   reach twice that, the bf16 ceiling). The __f*_rn intrinsics keep each
//   f32 op one instruction (no contraction into FMAs).
// - prim exp: the SFUs, 16 MUFU.EX2 results a clock per SM: 4.2e12/s.
// - the strip bodies: issue rate and latency of the port's sparse-skipping
//   inner loops (word or byte tests of the adjacency, then per edge an exp
//   and 8 FMAs), as in the flash kernels. An SM issues 4 warp-instructions
//   (128 thread-instructions) a clock. The forward body needs at least one
//   instruction (a shared-memory word test) per 4 elements of a thread's
//   slice, so at most 4 x 3.35e13 swept elements/s; the backward body one
//   byte test per element, so at most 3.35e13.
// A rate above 105 % of its ceiling means the compiler folded the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;          // strip side = the port's flash tile
constexpr int TPR = 4;          // threads per strip row (fwd), adjacent lanes
constexpr int WORDS = T / 4;    // int32 words of a strip row
constexpr int WPITCH = WORDS + 1;
constexpr int CW = WORDS / TPR;  // words in one thread's column slice
constexpr int D = 8;            // head dim (cal_vpu.py --d 8)
constexpr int HEADS = 8;        // head slots, passes unrolled by 8
constexpr int RW = 4;           // rows a warp holds in the primitive kernel
constexpr float NEG_INIT = -1e9f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Op { ADD = 0, MUL, LRELU, SELECT, EXP, ROWMAX, ROWSUM, N_OPS };

// one instruction per op, in f32 or bf16
__device__ __forceinline__ float op_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float op_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float op_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ bool op_ge0(float a) { return a >= 0.f; }
__device__ __forceinline__ float op_exp(float a) { return expf(a); }
__device__ __forceinline__ float to_f(float a) { return a; }

__device__ __forceinline__ __nv_bfloat16 op_add(__nv_bfloat16 a, __nv_bfloat16 b) { return __hadd(a, b); }
__device__ __forceinline__ __nv_bfloat16 op_mul(__nv_bfloat16 a, __nv_bfloat16 b) { return __hmul(a, b); }
__device__ __forceinline__ __nv_bfloat16 op_max(__nv_bfloat16 a, __nv_bfloat16 b) { return __hmax(a, b); }
__device__ __forceinline__ bool op_ge0(__nv_bfloat16 a) { return __hge(a, __float2bfloat16_rn(0.f)); }
__device__ __forceinline__ __nv_bfloat16 op_exp(__nv_bfloat16 a) { return hexp(a); }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) { return __bfloat162float(a); }

template <typename TT>
__device__ __forceinline__ TT from_f(float a);
template <>
__device__ __forceinline__ float from_f<float>(float a) { return a; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// primitives: a warp holds RW rows of 128 elements, 4 a lane, in registers;
// each pass applies cal_vpu.py's chain to all of them. The chain constants
// are exact in bf16 (1 +- 2^-7), so no pass folds to x1 (cal_vpu.py:37-41).
// ---------------------------------------------------------------------------

template <int OP, typename TT>
__global__ void __launch_bounds__(256) prim_kernel(const TT* __restrict__ x,
                                                   TT* __restrict__ out,
                                                   int n_rows, int reps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * RW;
  if (row0 >= n_rows) return;  // whole warps only: n_rows % RW == 0
  const TT c_add = from_f<TT>(0.0078125f), c_mul = from_f<TT>(0.9921875f);
  const TT c_slope = from_f<TT>(0.2f), c_tiny = from_f<TT>(1e-9f);
  const TT c_half = from_f<TT>(0.5f);
  TT acc[RW][4], aux[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[rr][e] = x[(size_t)(row0 + rr) * T + lane * 4 + e];
    aux[rr] = from_f<TT>(1.f);
  }
  for (int p = 0; p < reps; ++p) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      if constexpr (OP == ROWMAX) {
        const TT t = op_mul(aux[rr], c_tiny);
        float mx = to_f(op_add(acc[rr][0], t));
#pragma unroll
        for (int e = 1; e < 4; ++e) mx = fmaxf(mx, to_f(op_add(acc[rr][e], t)));
        aux[rr] = op_add(op_mul(aux[rr], c_half), from_f<TT>(warp_max(mx)));
      } else if constexpr (OP == ROWSUM) {
        const TT t = op_mul(aux[rr], c_tiny);
        float sm = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) sm += to_f(op_add(op_mul(acc[rr][e], c_tiny), t));
        aux[rr] = op_add(op_mul(aux[rr], c_half), from_f<TT>(warp_sum(sm)));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          TT& a = acc[rr][e];
          if constexpr (OP == ADD) a = op_add(a, c_add);
          if constexpr (OP == MUL) a = op_mul(a, c_mul);
          if constexpr (OP == LRELU) a = op_max(a, op_mul(c_slope, a));
          if constexpr (OP == SELECT) a = op_ge0(a) ? a : op_mul(a, c_mul);
          if constexpr (OP == EXP) a = op_exp(op_mul(a, c_tiny));
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(row0 + rr) * T + lane * 4 + e] = op_add(acc[rr][e], aux[rr]);
}

// ---------------------------------------------------------------------------
// forward strip bodies: block = one strip; thread (r, q) = row r, column
// slice q (32 columns), the TPR threads of a row on adjacent lanes. Each
// pass is the port's fwd_kernel tile body (csrc/flash_gat.cu): a max over
// the slice's edges, an online rescale, then per edge an exp and D FMAs,
// skipping empty words and bytes. The row's max is shared by its TPR
// lanes every pass (two shuffles), so the carry (m, l) is the row's, as in
// cal_vpu.py, and feeds the next pass (ld + m * 1e-9, cal_vpu.py:86).
// ---------------------------------------------------------------------------

// stage the strip's adjacency (padded rows: row r starts at bank r)
__device__ __forceinline__ void stage_adj_words(uint32_t* adj_s, const int8_t* adj, int s) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(adj + (size_t)s * T * T);
  for (int i = threadIdx.x; i < T * WORDS; i += blockDim.x) {
    const int rr = i / WORDS;
    adj_s[rr * WPITCH + (i - rr * WORDS)] = src[i];
  }
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(FULL_MASK, x, 1);
  return x + __shfl_xor_sync(FULL_MASK, x, 2);
}

template <bool MXU>
__global__ void __launch_bounds__(T * TPR) fwd_strip_kernel(
    const float* __restrict__ ld, const float* __restrict__ ls,
    const int8_t* __restrict__ adj, const float* __restrict__ v,
    float* __restrict__ out, int reps, float slope) {
  __shared__ uint32_t adj_s[T * WPITCH];
  __shared__ float ls_s[T];
  __shared__ float v_s[T * D];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int r = tid / TPR, q = tid % TPR;
  const int j0 = q * CW * 4;
  stage_adj_words(adj_s, adj, s);
  for (int j = tid; j < T; j += blockDim.x) ls_s[j] = ls[(size_t)s * HEADS * T + j];
  for (int i = tid; i < T * D; i += blockDim.x) v_s[i] = v[(size_t)s * T * D + i];
  __syncthreads();
  const float ld0 = ld[(size_t)s * HEADS * T + r];
  const uint32_t* my = adj_s + r * WPITCH + q * CW;

  float m = NEG_INIT, l = 0.f, acc[HEADS][D];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[h][d] = 0.f;

  for (int it = 0; it < reps / HEADS; ++it) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      const float ld_r = ld0 + m * 1e-9f;  // depend on the carry
      float cmax = NEG_INIT;
      for (int w = 0; w < CW; ++w) {
        const uint32_t bits = my[w];
        if (!bits) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((bits >> (8 * b)) & 0xffu) {
            const float raw = ld_r + ls_s[j0 + 4 * w + b];
            cmax = fmaxf(cmax, fmaxf(raw, slope * raw));
          }
        }
      }
      cmax = row_max(cmax);
      if (cmax == NEG_INIT) continue;  // an edgeless row: its lanes skip together
      const float m_new = fmaxf(m, cmax);
      const float scale = expf(m - m_new);
      l *= scale;
      if constexpr (MXU) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[h][d] *= scale;
      }
      for (int w = 0; w < CW; ++w) {
        const uint32_t bits = my[w];
        if (!bits) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((bits >> (8 * b)) & 0xffu) {
            const int j = j0 + 4 * w + b;
            const float raw = ld_r + ls_s[j];
            const float p = expf(fmaxf(raw, slope * raw) - m_new);
            l += p;
            if constexpr (MXU) {
              const float* vj = v_s + j * D;
#pragma unroll
              for (int d = 0; d < D; ++d) acc[h][d] = fmaf(p, vj[d], acc[h][d]);
            }
          }
        }
      }
      m = m_new;
    }
  }
  // the row's sums over its TPR slices; every slot written, as cal_vpu.py
  // keeps all 8 (only slot 0 is its output)
  l = row_sum(l);
  float* o = out + ((size_t)s * T + r) * HEADS * D;
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a = row_sum(acc[h][d]);
      if (q == 0) o[h * D + d] = a + m + l;
    }
}

// bf16 strip math (raw and z rounded to bf16, as cal_vpu.py:121-123), max,
// exp, sums and the accumulator in f32, p rounded to bf16 for p.v; one
// accumulator, no head slots (cal_vpu.py:112-141).
__global__ void __launch_bounds__(T * TPR) fwd_strip_bf16_kernel(
    const float* __restrict__ ld, const float* __restrict__ ls,
    const int8_t* __restrict__ adj, const __nv_bfloat16* __restrict__ v,
    float* __restrict__ out, int reps, float slope) {
  __shared__ uint32_t adj_s[T * WPITCH];
  __shared__ float ls_s[T];
  __shared__ __nv_bfloat16 v_s[T * D];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int r = tid / TPR, q = tid % TPR;
  const int j0 = q * CW * 4;
  stage_adj_words(adj_s, adj, s);
  for (int j = tid; j < T; j += blockDim.x) ls_s[j] = ls[(size_t)s * HEADS * T + j];
  for (int i = tid; i < T * D; i += blockDim.x) v_s[i] = v[(size_t)s * T * D + i];
  __syncthreads();
  const float ld0 = ld[(size_t)s * HEADS * T + r];
  const uint32_t* my = adj_s + r * WPITCH + q * CW;
  const __nv_bfloat16 slope16 = __float2bfloat16_rn(slope);

  float m = NEG_INIT, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int p_i = 0; p_i < reps; ++p_i) {
    const float ld_r = ld0 + m * 1e-9f;
    float cmax = NEG_INIT;
    for (int w = 0; w < CW; ++w) {
      const uint32_t bits = my[w];
      if (!bits) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((bits >> (8 * b)) & 0xffu) {
          const __nv_bfloat16 raw = __float2bfloat16_rn(ld_r + ls_s[j0 + 4 * w + b]);
          cmax = fmaxf(cmax, __bfloat162float(__hmax(raw, __hmul(slope16, raw))));
        }
      }
    }
    cmax = row_max(cmax);
    if (cmax == NEG_INIT) continue;
    const float m_new = fmaxf(m, cmax);
    const float scale = expf(m - m_new);
    l *= scale;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= scale;
    for (int w = 0; w < CW; ++w) {
      const uint32_t bits = my[w];
      if (!bits) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((bits >> (8 * b)) & 0xffu) {
          const int j = j0 + 4 * w + b;
          const __nv_bfloat16 raw = __float2bfloat16_rn(ld_r + ls_s[j]);
          const float z = __bfloat162float(__hmax(raw, __hmul(slope16, raw)));
          const float p = expf(z - m_new);
          l += p;
          const float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
          for (int d = 0; d < D; ++d)
            acc[d] = fmaf(pb, __bfloat162float(v_s[j * D + d]), acc[d]);
        }
      }
    }
    m = m_new;
  }
  l = row_sum(l);
  float* o = out + ((size_t)s * T + r) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float a = row_sum(acc[d]);
    if (q == 0) o[d] = a + m + l;
  }
}

// ---------------------------------------------------------------------------
// backward strip body: block = one strip; thread (j, q) = column j, rows
// q*32 .. q*32+31, as the port's bwd_col_kernel. Each pass is that kernel's
// tile body with FUSE_DLD: per edge c, g.v (D FMAs), dz with the lrelu
// derivative, dls and dv (D FMAs) in registers, and dld summed per row with
// a warp sum and a shared-memory atomicAdd. The carries are cal_vpu.py's
// (l.154-175): ld + dld * 1e-9 feeds the next pass, dls, dld and the pass's
// dv slot decay by 0.5. dld is double-buffered in shared memory (two
// barriers a pass); dls and dv are per-thread partials of linear
// recursions, merged over the TPR row slices once at the end.
// ---------------------------------------------------------------------------

constexpr size_t bwd_smem_bytes() {
  return (size_t)T * T                   // adjacency bytes
         + (size_t)T * 4 * 6             // ld0, ld, lse, delta, dld x2
         + (size_t)T * D * 4             // g
         + (size_t)T * (HEADS * D + 1) * 4;  // merge buffer
}

__global__ void __launch_bounds__(T * TPR) bwd_strip_kernel(
    const float* __restrict__ ld, const float* __restrict__ ls,
    const int8_t* __restrict__ adj, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int reps,
    float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* adj_s = smem;                                       // [T][T]
  float* ld0_s = reinterpret_cast<float*>(smem + T * T);       // [T]
  float* ld_s = ld0_s + T;                                     // [T]
  float* lse_s = ld_s + T;                                     // [T]
  float* delta_s = lse_s + T;                                  // [T]
  float* dld_s = delta_s + T;                                  // [2][T]
  float* g_s = dld_s + 2 * T;                                  // [T][D]
  float* red_s = g_s + T * D;                                  // [T][HEADS*D+1]
  const int s = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid % T, q = tid / T, lane = tid & 31;
  constexpr int RC = T / TPR;  // rows in a thread's slice

  const uint4* src = reinterpret_cast<const uint4*>(adj + (size_t)s * T * T);
  for (int i = tid; i < T * T / 16; i += nthr) reinterpret_cast<uint4*>(adj_s)[i] = src[i];
  for (int i = tid; i < T; i += nthr) {
    ld0_s[i] = ld[(size_t)s * HEADS * T + i];
    dld_s[i] = 0.f;
    dld_s[T + i] = 0.f;
  }
  for (int i = tid; i < T * D; i += nthr) g_s[i] = g[(size_t)s * T * D + i];
  const float ls_j = ls[(size_t)s * HEADS * T + j];
  float v_j[D], dv_j[HEADS][D], dls_j = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) v_j[d] = v[((size_t)s * T + j) * D + d];
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int d = 0; d < D; ++d) dv_j[h][d] = 0.f;

  const int n_pass = reps / HEADS * HEADS;
  for (int it = 0; it < reps / HEADS; ++it) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      const int pass = it * HEADS + h;
      const float* prev = dld_s + (pass & 1) * T;  // dld of the last pass
      float* cur = dld_s + ((pass & 1) ^ 1) * T;   // this pass's sums
      __syncthreads();  // the last pass's reads and atomics are done
      if (tid < T) {
        const float dl = prev[tid];
        const float l_ = ld0_s[tid] + dl * 1e-9f;  // depend on the carry
        ld_s[tid] = l_;
        lse_s[tid] = l_ * 0.5f;
        delta_s[tid] = l_ * 0.25f;
        cur[tid] = 0.5f * dl;
      }
      __syncthreads();
      dls_j *= 0.5f;
#pragma unroll
      for (int d = 0; d < D; ++d) dv_j[h][d] *= 0.5f;
      for (int ii = 0; ii < RC; ++ii) {
        const int i = q * RC + ii;
        const bool on_edge = adj_s[i * T + j] != 0;
        float dzs = 0.f;
        if (on_edge) {
          const float raw = ld_s[i] + ls_j;
          const float c = expf(fmaxf(raw, slope * raw) - lse_s[i]);
          const float* g_i = g_s + i * D;
          float gv = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) gv = fmaf(g_i[d], v_j[d], gv);
          const float dz = c * gv - c * delta_s[i];
          dzs = raw >= 0.f ? dz : slope * dz;
          dls_j += dzs;
#pragma unroll
          for (int d = 0; d < D; ++d) dv_j[h][d] = fmaf(c, g_i[d], dv_j[h][d]);
        }
        if (__any_sync(FULL_MASK, on_edge)) {  // warp-uniform: row i
          const float rs = warp_sum(dzs);
          if (lane == 0) atomicAdd(&cur[i], rs);
        }
      }
    }
  }
  __syncthreads();
  const float* dld = dld_s + (n_pass & 1) * T;  // the last pass's sums
  // merge the TPR row slices of column j, in thread order
  constexpr int PITCH = HEADS * D + 1;
  for (int qq = 1; qq < TPR; ++qq) {
    if (q == qq) {
#pragma unroll
      for (int h = 0; h < HEADS; ++h)
#pragma unroll
        for (int d = 0; d < D; ++d) red_s[j * PITCH + h * D + d] = dv_j[h][d];
      red_s[j * PITCH + HEADS * D] = dls_j;
    }
    __syncthreads();
    if (q == 0) {
#pragma unroll
      for (int h = 0; h < HEADS; ++h)
#pragma unroll
        for (int d = 0; d < D; ++d) dv_j[h][d] += red_s[j * PITCH + h * D + d];
      dls_j += red_s[j * PITCH + HEADS * D];
    }
    __syncthreads();
  }
  if (q != 0) return;
  float* o = out + ((size_t)s * T + j) * HEADS * D;
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int d = 0; d < D; ++d) o[h * D + d] = dv_j[h][d] + dls_j + dld[d];
}

template <int OP>
int launch_prim(int bf16, const void* x, void* out, int n_rows, int reps,
                cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32 * RW;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (bf16)
    prim_kernel<OP, __nv_bfloat16><<<blocks, threads, 0, stream>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n_rows, reps);
  else
    prim_kernel<OP, float><<<blocks, threads, 0, stream>>>(
        (const float*)x, (float*)out, n_rows, reps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Primitive passes. op 0..6 = add, mul, lrelu, select, exp, rowmax, rowsum;
// x, out f32 (or bf16 when bf16) [n_rows][128], n_rows % 4 == 0.
// Returns a cudaError_t code (0 = launched).
int han_cal_prim(int op, int bf16, const void* x, void* out, int n_rows,
                 int reps, void* stream) {
  if (n_rows <= 0 || n_rows % RW || reps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case ADD: return launch_prim<ADD>(bf16, x, out, n_rows, reps, st);
    case MUL: return launch_prim<MUL>(bf16, x, out, n_rows, reps, st);
    case LRELU: return launch_prim<LRELU>(bf16, x, out, n_rows, reps, st);
    case SELECT: return launch_prim<SELECT>(bf16, x, out, n_rows, reps, st);
    case EXP: return launch_prim<EXP>(bf16, x, out, n_rows, reps, st);
    case ROWMAX: return launch_prim<ROWMAX>(bf16, x, out, n_rows, reps, st);
    case ROWSUM: return launch_prim<ROWSUM>(bf16, x, out, n_rows, reps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Forward strip body, f32. ld, ls f32 [n_strips][8][128]; adj int8
// [n_strips][128][128]; v f32 [n_strips][128][8] -> out f32
// [n_strips][128][64] (all 8 head slots). reps % 8 == 0.
int han_cal_fwd_strip(int mxu, const void* ld, const void* ls,
                      const void* adj, const void* v, void* out,
                      int n_strips, int reps, float slope, void* stream) {
  if (n_strips <= 0 || reps < 0 || reps % HEADS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mxu)
    fwd_strip_kernel<true><<<n_strips, T * TPR, 0, st>>>(
        (const float*)ld, (const float*)ls, (const int8_t*)adj,
        (const float*)v, (float*)out, reps, slope);
  else
    fwd_strip_kernel<false><<<n_strips, T * TPR, 0, st>>>(
        (const float*)ld, (const float*)ls, (const int8_t*)adj,
        (const float*)v, (float*)out, reps, slope);
  return (int)cudaGetLastError();
}

// Forward strip body, bf16 strip math. As han_cal_fwd_strip with v bf16
// -> out f32 [n_strips][128][8].
int han_cal_fwd_strip_bf16(const void* ld, const void* ls, const void* adj,
                           const void* v, void* out, int n_strips, int reps,
                           float slope, void* stream) {
  if (n_strips <= 0 || reps < 0) return (int)cudaErrorInvalidValue;
  fwd_strip_bf16_kernel<<<n_strips, T * TPR, 0, (cudaStream_t)stream>>>(
      (const float*)ld, (const float*)ls, (const int8_t*)adj,
      (const __nv_bfloat16*)v, (float*)out, reps, slope);
  return (int)cudaGetLastError();
}

// Backward strip body. Adds g f32 [n_strips][128][8] -> out f32
// [n_strips][128][64] (dv slots + dls + dld[:8]). reps % 8 == 0.
int han_cal_bwd_strip(const void* ld, const void* ls, const void* adj,
                      const void* v, const void* g, void* out, int n_strips,
                      int reps, float slope, void* stream) {
  if (n_strips <= 0 || reps < 0 || reps % HEADS) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_strip_kernel<<<n_strips, T * TPR, smem, (cudaStream_t)stream>>>(
      (const float*)ld, (const float*)ls, (const int8_t*)adj, (const float*)v,
      (const float*)g, (float*)out, reps, slope);
  return (int)cudaGetLastError();
}

const char* han_cal_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
