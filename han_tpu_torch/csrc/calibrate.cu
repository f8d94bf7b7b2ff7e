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
// adjacency, ls, v, g, the head slots) for all R passes. Inputs per strip
// s: ld, ls f32 [8][128] (row 0 used, as cal_vpu.py uses ld_ref[0]), adj
// int8 [128][128] (every row holds an edge: see ops/calibrate.py), v
// [128][8], g f32 [128][8].
//
// The primitives read a unit's rate; the f32 strip bodies run the flash
// kernels' tile bodies (csrc/flash_gat.cu) with the same code (fwd_chunk,
// bwd_col_patch in csrc/tile_mma.cuh), so that a strip's time is the time
// of one tile and head of the flash kernels with nothing staged and no map
// walked.
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
// - the f32 strip bodies (fwd_strip_kernel, bwd_strip_kernel): branch-free
//   sweeps that issue one ex2 on every swept element, edge or not, so at
//   most the SFU rate, 4.2e12 swept elements/s. Besides it they issue about
//   a dozen (forward) and twenty (backward) FP32 and integer instructions an
//   element, and the products on the tensor cores: like the flash kernels
//   they are bound by instruction issue.
// - the bf16 forward strip body (fwd_strip_bf16_kernel, still the scalar
//   body): the issue rate of its sparse-skipping loops (a word test of
//   the adjacency per 4 elements of a thread's slice, then per edge an exp
//   and 8 FMAs), so at most 4 x 3.35e13 swept elements/s.
// A rate above 105 % of its ceiling means the compiler folded the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int T = 128;          // strip side = the port's flash tile
constexpr int TPR = 4;          // threads per strip row (bf16 fwd), adjacent lanes
constexpr int WORDS = T / 4;    // int32 words of a strip row
constexpr int WPITCH = WORDS + 1;
constexpr int CW = WORDS / TPR;  // words in one thread's column slice
constexpr int D = 8;            // head dim (cal_vpu.py --d 8)
constexpr int HEADS = 8;        // head slots of the f32 strip bodies
constexpr int RW = 4;           // rows a warp holds in the primitive kernel
constexpr int APITCH = T + APAD;  // bytes of a staged adjacency row, as the flash kernels'

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
// f32 forward strip body: fwd_kernel's tile body (csrc/flash_gat.cu) on one
// 128x128 tile held in shared memory, D = 8, f32 v, swept R times. Block =
// one strip, 8 warps laid out as fwd_kernel's at bm = 128: warp w owns rows
// 16 w .. 16 w + 15, thread (g, t) rows r_lo = 16 w + g and r_lo + 8 (the
// m16 side of P.V). A pass sweeps the tile as fwd_kernel sweeps one, with
// the same code: fwd_chunk (csrc/tile_mma.cuh) on each 32-column chunk,
// P.V as 3xTF32 on the tensor cores. MXU = false is the same sweep without
// the product. The carries are cal_vpu.py's (l.74-110): the row
// max m feeds the next pass's logits (ld + m 1e-9), and the P.V of pass p
// goes into head slot p % 8, which is rescaled by that pass's scale. The
// eight slots live in shared memory, one float4 a thread and slot, loaded
// and stored once a pass: in registers they would hold 32 a thread beside
// the body's, and fwd_kernel itself needs up to 128.
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = T / 16 * 32;

constexpr size_t fwd_smem_bytes(bool mxu) {
  return (size_t)T * APITCH + (size_t)T * 4 + (size_t)T * D * 4  // adjacency, ls, v
         + (mxu ? (size_t)HEADS * FWD_THREADS * 16 : 0);         // the head slots
}

// the strip's adjacency, rows padded to APITCH bytes as the flash kernels
// stage a tile (the rows a warp reads at one column hit distinct banks)
__device__ __forceinline__ void stage_adj_rows(unsigned char* adj_s, const int8_t* adj, int s) {
  const uint4* src = reinterpret_cast<const uint4*>(adj + (size_t)s * T * T);
  for (int i = threadIdx.x; i < T * T / 16; i += blockDim.x) {
    const int r = i / (T / 16);
    *reinterpret_cast<uint4*>(adj_s + r * APITCH + 16 * (i - r * (T / 16))) = src[i];
  }
}

template <bool MXU>
__global__ void __launch_bounds__(FWD_THREADS, 2) fwd_strip_kernel(
    const float* __restrict__ ld, const float* __restrict__ ls,
    const int8_t* __restrict__ adj, const float* __restrict__ v,
    float* __restrict__ out, int reps, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* adj_s = smem;                                // [T][APITCH]
  float* ls_s = reinterpret_cast<float*>(smem + T * APITCH);  // [T]
  float* v_s = ls_s + T;                                      // [T][D], column c at vslot(c)
  float4* slot_s = reinterpret_cast<float4*>(v_s + T * D);    // [HEADS][FWD_THREADS]
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r_lo = (tid >> 5) * 16 + gq;  // rows r_lo and r_lo + 8
  stage_adj_rows(adj_s, adj, s);
  for (int j = tid; j < T; j += FWD_THREADS) ls_s[j] = ls[(size_t)s * HEADS * T + j];
  for (int i = tid; i < T * D; i += FWD_THREADS)
    v_s[vslot(i / D) * D + i % D] = v[(size_t)s * T * D + i];
  if constexpr (MXU)
    for (int h = 0; h < HEADS; ++h)
      slot_s[h * FWD_THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // per row: ld, the running max m (both in the log2 domain; m starts at
  // cal_vpu.py's -1e9) and this thread's part of the running sum l
  float ld2[2], m[2], l[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    ld2[rr] = ld[(size_t)s * HEADS * T + r_lo + 8 * rr] * LOG2E;
    m[rr] = NEG_INIT * LOG2E;
    l[rr] = 0.f;
  }
  // this thread's v columns of a 16-column window at k step hh, after the
  // swizzle: vslot(base + r) = base + vslot(r) for base a multiple of 16
  const int vo[2][2] = {{vslot(4 * tq) * D, vslot(4 * tq + 1) * D},
                        {vslot(4 * tq + 2) * D, vslot(4 * tq + 3) * D}};
  const uint32_t no_key[2] = {0u, 0u};  // no dropout

  for (int pass = 0; pass < reps; ++pass) {
    // this pass's logits depend on the last pass's max: (ld + m 1e-9) log2e
    float ldp[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) ldp[rr] = fmaf(m[rr], 1e-9f, ld2[rr]);
    // the hi.hi, hi.lo and lo.hi terms of the pass's slot, hi.hi from the slot
    float acc[3][1][4] = {};
    float4* slot = slot_s + (pass & (HEADS - 1)) * FWD_THREADS + tid;
    if constexpr (MXU) {
      const float4 a = *slot;
      acc[0][0][0] = a.x;
      acc[0][0][1] = a.y;
      acc[0][0][2] = a.z;
      acc[0][0][3] = a.w;
    }
#pragma unroll 2
    for (int c0 = 0; c0 < T; c0 += 32)
      fwd_chunk<D, float, false, MXU>(adj_s, APITCH, ls_s, nullptr, v_s, vo, c0, r_lo, gq, tq,
                                      ldp, slope, no_key, 0u, m, l, acc, [] {});
    if constexpr (MXU)
      *slot = make_float4(acc[1][0][0] + acc[2][0][0] + acc[0][0][0],
                          acc[1][0][1] + acc[2][0][1] + acc[0][0][1],
                          acc[1][0][2] + acc[2][0][2] + acc[0][0][2],
                          acc[1][0][3] + acc[2][0][3] + acc[0][0][3]);
  }

  // l over the quad; every slot written (acc + (m + l)), as cal_vpu.py keeps
  // all 8 (only slot 0 is its output). A thread's slot entries are (row
  // r_lo, d = 2 t, 2 t + 1) and (row r_lo + 8, the same d): its own.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr] + __shfl_xor_sync(FULL_MASK, l[rr], 1);
    lt += __shfl_xor_sync(FULL_MASK, lt, 2);
    const float ml = m[rr] * LN2 + lt;
    float* o = out + ((size_t)s * T + r_lo + 8 * rr) * HEADS * D + 2 * tq;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float2 a = make_float2(0.f, 0.f);
      if constexpr (MXU) {
        const float4 sl = slot_s[h * FWD_THREADS + tid];
        a = rr ? make_float2(sl.z, sl.w) : make_float2(sl.x, sl.y);
      }
      *reinterpret_cast<float2*>(o + h * D) = make_float2(a.x + ml, a.y + ml);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward strip body (the first port's scalar body): block = one
// strip; thread (r, q) = row r, column slice q (32 columns), the TPR threads
// of a row on adjacent lanes. Each pass: a max over the slice's edges, an online
// rescale, then per edge an exp and D FMAs, skipping empty words and bytes.
// The row's max is shared by its TPR lanes every pass (two shuffles), so
// the carry (m, l) is the row's, as in cal_vpu.py, and feeds the next pass
// (ld + m * 1e-9, cal_vpu.py:118).
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
// backward strip body: bwd_col_kernel<8, true, float, false>'s tile body
// (csrc/flash_gat.cu) on one 128x128 tile held in shared memory, swept R
// times. Block = one strip, 8 warps laid out as bwd_col_kernel's at bn =
// 128: warp (cq, rh) owns columns 32 cq .. 32 cq + 31 and the rh-th half of
// the rows, thread (g, t) the columns j0 = 32 cq + 4 g .. j0 + 3 as the m
// side of gv = V.G^T and dv += C.G, in patches of 8 rows. A pass sweeps the
// tile as bwd_col_kernel sweeps one, with the same code: bwd_col_patch
// (csrc/tile_mma.cuh) on each patch, g.v and c.g as 3xTF32 on the tensor
// cores with v's split held in registers; dld is summed over the warp's
// columns by shuffles and across the column warps in shared memory. The carries
// are cal_vpu.py's (l.144-187): the rows' ld + dld 1e-9 feed the next pass
// (lse = ld / 2, delta = ld / 4), and dls, dld and the pass's dv slot decay
// by 0.5. dld is the calibration's dependency chain: a pass's column-warp
// partials are complete at one block barrier a pass, after which every warp
// forms the next pass's row vectors for its half (a lane two rows, the four
// column warps of a half alike) in its own shared memory. The eight dv
// slots live in shared memory, two float4 a thread and slot, loaded and
// stored once a pass.
// ---------------------------------------------------------------------------

constexpr int N_CW = T / 32;               // column warps
constexpr int BWD_THREADS = 2 * N_CW * 32;  // and two row halves
constexpr int HALF = T / 2;
constexpr int GP = gpitch(D);

constexpr size_t bwd_smem_bytes() {
  return (size_t)T * APITCH                            // adjacency
         + (size_t)T * GP * 4                          // g
         + (size_t)T * 4                               // ld
         + (size_t)2 * N_CW * T * 4                    // dld partials of two passes
         + (size_t)(BWD_THREADS / 32) * 3 * HALF * 4   // each warp's ld, lse, delta
         + (size_t)(T + D) * 4                         // the final merge: dls, dld[:8]
         + (size_t)HEADS * 2 * BWD_THREADS * 16;       // the dv slots
}

__global__ void __launch_bounds__(BWD_THREADS, 2) bwd_strip_kernel(
    const float* __restrict__ ld, const float* __restrict__ ls,
    const int8_t* __restrict__ adj, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ out, int reps, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* adj_s = smem;                               // [T][APITCH]
  float* g_s = reinterpret_cast<float*>(smem + T * APITCH);  // [T][GP]
  float* ld0_s = g_s + T * GP;                               // [T]
  float* part_s = ld0_s + T;                                 // [2][N_CW][T]
  float* vec_s = part_s + 2 * N_CW * T;                      // [warp][ld, lse, delta][HALF]
  float* red_s = vec_s + (BWD_THREADS / 32) * 3 * HALF;      // [T + D]
  float4* slot_s = reinterpret_cast<float4*>(red_s + T + D);  // [HEADS][2][BWD_THREADS]
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int warp = tid >> 5, cq = warp % N_CW, rh = warp / N_CW;
  const int j0 = 32 * cq + 4 * gq;

  stage_adj_rows(adj_s, adj, s);
  for (int i = tid; i < T * D; i += BWD_THREADS)
    g_s[(i / D) * GP + i % D] = g[(size_t)s * T * D + i];
  for (int i = tid; i < T; i += BWD_THREADS) {
    ld0_s[i] = ld[(size_t)s * HEADS * T + i];
#pragma unroll
    for (int q = 0; q < N_CW; ++q) part_s[(N_CW + q) * T + i] = 0.f;  // what pass 0 reads
  }
  for (int i = tid; i < HEADS * 2 * BWD_THREADS; i += BWD_THREADS)
    slot_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // per column: ls, and v as the A operand of g.v (a0 (column j0 + 2 tile,
  // d = t), a1 (j0 + 2 tile + 1, t), a2 (j0 + 2 tile, t + 4), a3 (j0 +
  // 2 tile + 1, t + 4))
  float ls_j[4], dls_j[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) ls_j[j4] = ls[(size_t)s * HEADS * T + j0 + j4];
  Tf32x2 va[2][1][4];
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int idx = 0; idx < 4; ++idx)
      va[tile][0][idx] = split_tf32(
          v[((size_t)s * T + j0 + 2 * tile + (idx & 1)) * D + tq + 4 * (idx >> 1)]);
  const uint32_t no_key[4] = {0u, 0u, 0u, 0u};  // no dropout
  // the rows whose carry this lane forms: ra and ra + 1 of its half
  const int ra = rh * HALF + 2 * lane;
  float dld_r[2] = {0.f, 0.f};
  float* vec_w = vec_s + warp * 3 * HALF;
  __syncthreads();

  for (int pass = 0; pass < reps; ++pass) {
    // dld after the last pass (dld / 2 + the column warps' partials), then
    // this pass's rows: ld + dld 1e-9, lse = ld / 2, delta = ld / 4
    {
      const float* prev = part_s + ((pass + 1) & 1) * N_CW * T;
      float2 sum = *reinterpret_cast<const float2*>(prev + ra);
#pragma unroll
      for (int q = 1; q < N_CW; ++q) {
        const float2 x = *reinterpret_cast<const float2*>(prev + q * T + ra);
        sum.x += x.x;
        sum.y += x.y;
      }
      dld_r[0] = fmaf(dld_r[0], 0.5f, sum.x);
      dld_r[1] = fmaf(dld_r[1], 0.5f, sum.y);
      const float2 l0 = *reinterpret_cast<const float2*>(ld0_s + ra);
      const float la = fmaf(dld_r[0], 1e-9f, l0.x), lb = fmaf(dld_r[1], 1e-9f, l0.y);
      *reinterpret_cast<float2*>(vec_w + 2 * lane) = make_float2(la, lb);
      *reinterpret_cast<float2*>(vec_w + HALF + 2 * lane) = make_float2(la * 0.5f, lb * 0.5f);
      *reinterpret_cast<float2*>(vec_w + 2 * HALF + 2 * lane) =
          make_float2(la * 0.25f, lb * 0.25f);
      __syncwarp();
    }
    // dls and this pass's dv slot decay
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) dls_j[j4] *= 0.5f;
    float4* slot = slot_s + (pass & (HEADS - 1)) * 2 * BWD_THREADS + tid;
    float dv_acc[2][1][4];
    {
      const float4 a = slot[0], b = slot[BWD_THREADS];
      const float sa[4] = {a.x, a.y, a.z, a.w}, sb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv_acc[0][0][e] = 0.5f * sa[e];
        dv_acc[1][0][e] = 0.5f * sb[e];
      }
    }
    float* cur = part_s + (pass & 1) * N_CW * T + cq * T;  // this pass's dld partials

#pragma unroll 2
    for (int i0 = rh * HALF; i0 < rh * HALF + HALF; i0 += 8)
      bwd_col_patch<D, float, false, true>(adj_s, APITCH, g_s, vec_w, vec_w + HALF,
                                           vec_w + 2 * HALF, nullptr, rh * HALF, i0, j0, gq, tq,
                                           va, ls_j, no_key, slope, 0u, 1.f, dls_j, dv_acc, cur,
                                           [] {});
    slot[0] = make_float4(dv_acc[0][0][0], dv_acc[0][0][1], dv_acc[0][0][2], dv_acc[0][0][3]);
    slot[BWD_THREADS] =
        make_float4(dv_acc[1][0][0], dv_acc[1][0][1], dv_acc[1][0][2], dv_acc[1][0][3]);
    __syncthreads();  // this pass's dld partials are complete
  }

  // dld after the last pass for rows 0 .. 7 (warp 0, whose lanes 0 .. 3
  // carry them): the output's dld[:8]
  if (warp == 0 && lane < D / 2) {
    const float* last = part_s + ((reps + 1) & 1) * N_CW * T;
    float2 sum = *reinterpret_cast<const float2*>(last + ra);
#pragma unroll
    for (int q = 1; q < N_CW; ++q) {
      const float2 x = *reinterpret_cast<const float2*>(last + q * T + ra);
      sum.x += x.x;
      sum.y += x.y;
    }
    red_s[T + ra] = fmaf(dld_r[0], 0.5f, sum.x);
    red_s[T + ra + 1] = fmaf(dld_r[1], 0.5f, sum.y);
  }
  // dls over the quad (the thread's rows), then the two row halves in a
  // fixed order (half 1 through shared memory)
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) {
    dls_j[j4] += __shfl_xor_sync(FULL_MASK, dls_j[j4], 1);
    dls_j[j4] += __shfl_xor_sync(FULL_MASK, dls_j[j4], 2);
  }
  if (rh == 1 && tq == 0)
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) red_s[j0 + j4] = dls_j[j4];
  __syncthreads();
  if (rh != 0) return;
  // every slot: (dv of half 0 + dv of half 1, thread tid + BWD_THREADS / 2)
  // + dls + dld[d];
  // dv[tile][e] is column j0 + 2 tile + e / 2, d = 2 t + e % 2
  float dls_c[4];
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) dls_c[j4] = dls_j[j4] + red_s[j0 + j4];
  const float2 dld_d = *reinterpret_cast<const float2*>(red_s + T + 2 * tq);
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    const float4* sl = slot_s + h * 2 * BWD_THREADS + tid;
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      const float4 a = sl[tile * BWD_THREADS], b = sl[tile * BWD_THREADS + BWD_THREADS / 2];
      const float dv[4] = {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
#pragma unroll
      for (int ep = 0; ep < 2; ++ep) {
        const int j4 = 2 * tile + ep;
        float* o = out + (((size_t)s * T + j0 + j4) * HEADS + h) * D + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2((dv[2 * ep] + dls_c[j4]) + dld_d.x,
                                                    (dv[2 * ep + 1] + dls_c[j4]) + dld_d.y);
      }
    }
  }
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
  const size_t smem = fwd_smem_bytes(mxu);
  auto kernel = mxu ? fwd_strip_kernel<true> : fwd_strip_kernel<false>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_strips, FWD_THREADS, smem, st>>>((const float*)ld, (const float*)ls,
                                              (const int8_t*)adj, (const float*)v,
                                              (float*)out, reps, slope);
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
  const cudaError_t err = set_smem(bwd_strip_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_strip_kernel<<<n_strips, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)ld, (const float*)ls, (const int8_t*)adj, (const float*)v,
      (const float*)g, (float*)out, reps, slope);
  return (int)cudaGetLastError();
}

const char* han_cal_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
