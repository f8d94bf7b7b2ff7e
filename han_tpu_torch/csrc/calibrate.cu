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
//   prim_kernel<OP, U>            <- _prim_kernel (l.63) with _prim_body (l.35-60)
//   fwd_strip_kernel<MXU, float>  <- _fwd_strip_kernel (l.74)
//   fwd_strip_kernel<true, bf16>  <- _fwd_strip_kernel_bf16 (l.112), as the
//                                    body of the bf16 flash forward (below)
//   bwd_strip_kernel              <- _bwd_strip_kernel (l.144)
//
// The unit of work is the whole card: n_strips independent 128x128 strips
// (the port's flash tile, graph/bcsr.py), one thread block each for the
// strip bodies, or rows of 128 elements, 8 rows a warp, for the primitives;
// a launch fills all 132 SMs. Each block loads its slice once and keeps it
// in registers (primitives, carries, accumulators) and shared memory (the
// adjacency, ls, v, g, the head slots) for all R passes. Inputs per strip
// s: ld, ls f32 [8][128] (row 0 used, as cal_vpu.py uses ld_ref[0]), adj
// int8 [128][128] (every row holds an edge: see ops/calibrate.py), v
// [128][8] (f32, or bf16 for the bf16 strip), g f32 [128][8].
//
// The primitives read a unit's rate; the strip bodies run the flash
// kernels' tile bodies (csrc/flash_gat.cu) with the same code (fwd_chunk,
// bwd_col_patch in csrc/tile_mma.cuh), so that a strip's time is the time
// of one tile and head of the flash kernels with nothing staged and no map
// walked. The bf16 strip is the bf16 flash forward's body (fwd_kernel<8,
// bf16, false>: v bf16, widened in registers, everything else in f32, as
// han_tpu's bf16 flash kernel computes), not cal_vpu.py's bf16 roundings of
// raw, z and p, which no flash kernel of either package makes.
//
// What bounds each on the H100 (the ceilings cal_vpu_torch.py holds every
// rate to, from the card's SM count and maximum SM clock; at 132 SMs and
// 1.98 GHz):
// - prim add, mul, lrelu, select, rowmax, rowsum: the FP32 lanes, 128 per
//   SM: 132 x 128 x clock = 3.35e13 simple f32 ops/s, and so at most
//   3.35e13 elements/s in f32 for a pass that needs one instruction an
//   element. bf16 data is held as __nv_bfloat162 pairs, one packed
//   instruction for two elements, so the bf16 ceiling is twice that. On
//   the H100 a chain of packed multiplies comes near it (ptxas splits them
//   between HMUL2 on the FMA pipe and HFMA2.MMA); a chain of packed adds
//   issues as HADD2 (or HFMA2) on the FMA pipe alone, at the f32 rate. The
//   __f*_rn and __h*2_rn intrinsics keep each op one instruction (no
//   contraction into FMAs). A row's max or sum is an in-thread tree over
//   the lane's 32 elements and two quad shuffles.
// - prim exp: the SFUs, 16 MUFU.EX2 results a clock per SM: 4.2e12/s.
// - the strip bodies (fwd_strip_kernel, bwd_strip_kernel): branch-free
//   sweeps that issue one ex2 on every swept element, edge or not, so at
//   most the SFU rate, 4.2e12 swept elements/s. Besides it they issue about
//   a dozen (forward) and twenty (backward) FP32 and integer instructions an
//   element, and the products on the tensor cores: like the flash kernels
//   they are bound by instruction issue.
// A rate above 105 % of its ceiling means the compiler folded the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

constexpr int T = 128;          // strip side = the port's flash tile
constexpr int D = 8;            // head dim (cal_vpu.py --d 8)
constexpr int HEADS = 8;        // head slots of the strip bodies
constexpr int APITCH = T + APAD;  // bytes of a staged adjacency row, as the flash kernels'

enum Op { ADD = 0, MUL, LRELU, SELECT, EXP, ROWMAX, ROWSUM, N_OPS };

// ---------------------------------------------------------------------------
// primitives: lane q of a quad holds elements 32 q .. 32 q + 31 of one row
// in registers, a warp 8 rows; each pass applies cal_vpu.py's chain to all
// of them. The unit U of the registers is an f32 element, or a pair of
// bf16 elements (__nv_bfloat162) on which each op is one packed
// instruction. The chain constants are exact in bf16 (1 +- 2^-7), so no
// pass folds to x1 (cal_vpu.py:37-41). A block of 1,024 threads holds 256
// rows: at one or two blocks an SM, the calibration's 135,168 rows make
// whole waves.
// ---------------------------------------------------------------------------

constexpr int PRIM_THREADS = 1024;
constexpr int LPR = 4;           // lanes of a row: a quad
constexpr int RPW = 32 / LPR;    // rows a warp
constexpr int RUN = T / LPR;     // a lane's contiguous elements of its row

using bf2 = __nv_bfloat162;

// a unit's 32 bits and back
__device__ __forceinline__ uint32_t bits(float a) { return __float_as_uint(a); }
__device__ __forceinline__ uint32_t bits(bf2 a) { return reinterpret_cast<const uint32_t&>(a); }
template <typename U>
__device__ __forceinline__ U from_bits(uint32_t u);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t u) { return __uint_as_float(u); }
template <>
__device__ __forceinline__ bf2 from_bits<bf2>(uint32_t u) {
  return reinterpret_cast<const bf2&>(u);
}

template <typename U>
__device__ __forceinline__ U splat(float x);
template <>
__device__ __forceinline__ float splat<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf2 splat<bf2>(float x) { return __float2bfloat162_rn(x); }

__device__ __forceinline__ float op_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float op_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float op_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float op_select(float a, float c_mul) {
  return a >= 0.f ? a : op_mul(a, c_mul);
}
__device__ __forceinline__ float op_exp(float a) { return expf(a); }

__device__ __forceinline__ bf2 op_add(bf2 a, bf2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ bf2 op_mul(bf2 a, bf2 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ bf2 op_max(bf2 a, bf2 b) { return __hmax2(a, b); }
// a >= 0 ? a : a c_mul on both halves: a packed compare gives each half's
// mask, one bitwise select merges
__device__ __forceinline__ bf2 op_select(bf2 a, bf2 c_mul) {
  const uint32_t keep = __hge2_mask(a, splat<bf2>(0.f));
  return from_bits<bf2>((bits(a) & keep) | (bits(op_mul(a, c_mul)) & ~keep));
}
__device__ __forceinline__ bf2 op_exp(bf2 a) { return h2exp(a); }

// a unit's sum in f32, for the row sums (summed in f32, as the plain
// version's bf16 .sum is). A bf16 value widens to the f32 of its bits
// shifted up by 16. Written as a multiply and a mask, the two widenings
// take fewer integer-pipe instructions than __low2float and __high2float
// (PRMT and shifts): 8.7e12 against 7.9e12 elements/s on the H100
__device__ __forceinline__ float sum_f32(float a) { return a; }
__device__ __forceinline__ float sum_f32(bf2 a) {
  const uint32_t u = bits(a);
  return __uint_as_float(u * 65536u) + __uint_as_float(u & 0xffff0000u);
}

// a unit whose halves are the row's max: the halves' max (bf16), then the
// quad's
__device__ __forceinline__ float halves_max(float a) { return a; }
__device__ __forceinline__ bf2 halves_max(bf2 a) { return __hmax2(a, __lowhigh2highlow(a)); }

template <typename U>
__device__ __forceinline__ U quad_max(U a) {
  a = op_max(a, __shfl_xor_sync(FULL_MASK, a, 1));
  return op_max(a, __shfl_xor_sync(FULL_MASK, a, 2));
}

__device__ __forceinline__ float quad_sum(float a) {
  a += __shfl_xor_sync(FULL_MASK, a, 1);
  return a + __shfl_xor_sync(FULL_MASK, a, 2);
}

// f over leaf(LO) .. leaf(LO + N - 1): a pairwise tree, built depth first
// so that few values are live at once
template <int LO, int N, typename G, typename F>
__device__ __forceinline__ auto tree(const G& leaf, const F& f) {
  if constexpr (N == 1)
    return leaf(LO);
  else
    return f(tree<LO, N / 2>(leaf, f), tree<LO + N / 2, N / 2>(leaf, f));
}

// x, unknown to the compiler at each pass: rowsum's acc x 1e-9 is the same
// every pass, and the chain computes it every pass, as the bound counts it
template <typename U>
__device__ __forceinline__ void opaque(U& x) {
  uint32_t u = bits(x);
  asm volatile("" : "+r"(u));
  x = from_bits<U>(u);
}

template <int OP, typename U>
__global__ void __launch_bounds__(PRIM_THREADS) prim_kernel(const U* __restrict__ x,
                                                            U* __restrict__ out,
                                                            int n_rows, int reps) {
  constexpr int EPU = std::is_same<U, float>::value ? 1 : 2;  // elements a unit
  constexpr int N = RUN / EPU;                                // units a lane
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp * RPW >= n_rows) return;  // whole warps only: n_rows % RPW == 0
  const size_t at = ((size_t)(warp * RPW + lane / LPR) * T + (lane % LPR) * RUN) / EPU;
  const U c_add = splat<U>(0.0078125f), c_mul = splat<U>(0.9921875f);
  const U c_slope = splat<U>(0.2f), c_half = splat<U>(0.5f);
  U c_tiny = splat<U>(1e-9f);
  U acc[N], aux = splat<U>(1.f);  // aux: the row's, in every unit
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint4 w = reinterpret_cast<const uint4*>(x + at)[i];
    acc[4 * i] = from_bits<U>(w.x);
    acc[4 * i + 1] = from_bits<U>(w.y);
    acc[4 * i + 2] = from_bits<U>(w.z);
    acc[4 * i + 3] = from_bits<U>(w.w);
  }
  for (int p = 0; p < reps; ++p) {
    if constexpr (OP == ROWMAX) {
      const U t = op_mul(aux, c_tiny);
      const U mx = tree<0, N>([&](int e) { return op_add(acc[e], t); },
                              [](U a, U b) { return op_max(a, b); });
      aux = op_add(op_mul(aux, c_half), quad_max(halves_max(mx)));
    } else if constexpr (OP == ROWSUM) {
      opaque(c_tiny);
      const U t = op_mul(aux, c_tiny);
      const float sm =
          tree<0, N>([&](int e) { return sum_f32(op_add(op_mul(acc[e], c_tiny), t)); },
                     [](float a, float b) { return a + b; });
      aux = op_add(op_mul(aux, c_half), splat<U>(quad_sum(sm)));
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        U& a = acc[e];
        if constexpr (OP == ADD) a = op_add(a, c_add);
        if constexpr (OP == MUL) a = op_mul(a, c_mul);
        if constexpr (OP == LRELU) a = op_max(a, op_mul(c_slope, a));
        if constexpr (OP == SELECT) a = op_select(a, c_mul);
        if constexpr (OP == EXP) a = op_exp(op_mul(a, c_tiny));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<uint4*>(out + at)[i] =
        make_uint4(bits(op_add(acc[4 * i], aux)), bits(op_add(acc[4 * i + 1], aux)),
                   bits(op_add(acc[4 * i + 2], aux)), bits(op_add(acc[4 * i + 3], aux)));
}

// ---------------------------------------------------------------------------
// forward strip body: fwd_kernel's tile body (csrc/flash_gat.cu) on one
// 128x128 tile held in shared memory, D = 8, v f32 or bf16 (VT), swept R
// times. Block = one strip, 8 warps laid out as fwd_kernel's at bm = 128:
// warp w owns rows 16 w .. 16 w + 15, thread (g, t) rows r_lo = 16 w + g
// and r_lo + 8 (the m16 side of P.V). A pass sweeps the tile as fwd_kernel
// sweeps one, with the same code: fwd_chunk (csrc/tile_mma.cuh) on each
// 32-column chunk, P.V as 3xTF32 on the tensor cores (two products a k
// step with bf16 v, whose widened values are exact in TF32, as
// fwd_kernel<8, bf16, false> takes them). v is staged as VT, 2 bytes an
// element for bf16. MXU = false is the same sweep without the product.
// The carries are cal_vpu.py's (l.74-110): the row
// max m feeds the next pass's logits (ld + m 1e-9), and the P.V of pass p
// goes into head slot p % 8, which is rescaled by that pass's scale. The
// eight slots live in shared memory, one float4 a thread and slot, loaded
// and stored once a pass: in registers they would hold 32 a thread beside
// the body's, and fwd_kernel itself needs up to 128.
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = T / 16 * 32;

constexpr size_t fwd_smem_bytes(bool mxu, size_t v_bytes) {
  return (size_t)T * APITCH + (size_t)T * 4 + (size_t)T * D * v_bytes  // adjacency, ls, v
         + (mxu ? (size_t)HEADS * FWD_THREADS * 16 : 0);               // the head slots
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

template <bool MXU, typename VT>
__global__ void __launch_bounds__(FWD_THREADS, 2) fwd_strip_kernel(
    const float* __restrict__ ld, const float* __restrict__ ls,
    const int8_t* __restrict__ adj, const VT* __restrict__ v,
    float* __restrict__ out, int reps, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* adj_s = smem;                                // [T][APITCH]
  float* ls_s = reinterpret_cast<float*>(smem + T * APITCH);  // [T]
  VT* v_s = reinterpret_cast<VT*>(ls_s + T);                  // [T][D], column c at vslot(c)
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
      fwd_chunk<D, VT, false, MXU>(adj_s, APITCH, ls_s, nullptr, v_s, vo, c0, r_lo, gq, tq, ldp,
                                   slope, no_key, 0u, m, l, acc, [] {});
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
  const int rows_per_block = PRIM_THREADS / 32 * RPW;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (bf16)
    prim_kernel<OP, bf2><<<blocks, PRIM_THREADS, 0, stream>>>((const bf2*)x, (bf2*)out, n_rows,
                                                              reps);
  else
    prim_kernel<OP, float><<<blocks, PRIM_THREADS, 0, stream>>>((const float*)x, (float*)out,
                                                                n_rows, reps);
  return (int)cudaGetLastError();
}

template <bool MXU, typename VT>
int launch_fwd_strip(const void* ld, const void* ls, const void* adj, const void* v, void* out,
                     int n_strips, int reps, float slope, cudaStream_t stream) {
  if (n_strips <= 0 || reps < 0 || reps % HEADS) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(MXU, sizeof(VT));
  const cudaError_t err = set_smem(fwd_strip_kernel<MXU, VT>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_strip_kernel<MXU, VT><<<n_strips, FWD_THREADS, smem, stream>>>(
      (const float*)ld, (const float*)ls, (const int8_t*)adj, (const VT*)v, (float*)out, reps,
      slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Primitive passes. op 0..6 = add, mul, lrelu, select, exp, rowmax, rowsum;
// x, out f32 (or bf16 when bf16) [n_rows][128], n_rows % 8 == 0.
// Returns a cudaError_t code (0 = launched).
int han_cal_prim(int op, int bf16, const void* x, void* out, int n_rows,
                 int reps, void* stream) {
  if (n_rows <= 0 || n_rows % RPW || reps < 0) return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = (cudaStream_t)stream;
  return mxu ? launch_fwd_strip<true, float>(ld, ls, adj, v, out, n_strips, reps, slope, st)
             : launch_fwd_strip<false, float>(ld, ls, adj, v, out, n_strips, reps, slope, st);
}

// Forward strip body with p.v, v bf16: the bf16 flash forward's body. As
// han_cal_fwd_strip otherwise (out f32 [n_strips][128][64], reps % 8 == 0).
int han_cal_fwd_strip_bf16(const void* ld, const void* ls, const void* adj,
                           const void* v, void* out, int n_strips, int reps,
                           float slope, void* stream) {
  return launch_fwd_strip<true, __nv_bfloat16>(ld, ls, adj, v, out, n_strips, reps, slope,
                                               (cudaStream_t)stream);
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
