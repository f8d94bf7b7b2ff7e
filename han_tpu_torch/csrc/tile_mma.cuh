// The flash tile bodies and their device helpers, shared by
// csrc/flash_gat.cu (the flash kernels, which run a body on each staged
// tile) and csrc/calibrate.cu (the strip bodies, which run it R times on one
// 128x128 tile held in shared memory, so that a strip times one tile and
// head of the flash kernels): the log2-domain constants and exp2, the
// dropout hash's halves, the 3xTF32 products on mma.sync.m16n8k8, the
// shared-memory swizzles of the staged v columns and g rows, one 32-column
// chunk of the forward's sweep (fwd_chunk), one 8-row patch of the column
// sweep (bwd_col_patch), and the host's shared-memory set-up of a launch.
// ops/flash_gat.py:split_tf32 and mm_3xtf32 are the plain mirrors of the
// split and the products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INIT = -1e9f;  // = MASK_VALUE
constexpr float NEG2 = -1e30f;     // a masked logit in the log2 domain
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int APAD = 16;  // bytes that pad each staged adjacency row

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v is float or bf16 (VT); it is widened to f32 in registers right after the
// load, and everything else computes and accumulates in f32
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The dropout hash is the murmur3 finalizer of (row key, column). Its first
// xor-shift distributes over xor, so the bits are drop_tail(drop_half(row
// key) ^ drop_half(column key)): the kernels hash each half once a row or
// column and only the tail once an element.
__device__ __forceinline__ uint32_t drop_half(uint32_t h) { return h ^ (h >> 16); }

__device__ __forceinline__ uint32_t drop_tail(uint32_t h) {
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ---------------------------------------------------------------------------
// tensor-core products: mma.sync.m16n8k8 with TF32 operands, split 3 ways
// (ops/flash_gat.py:split_tf32 is the plain mirror of the split)
// ---------------------------------------------------------------------------

struct Tf32x2 {
  uint32_t hi, lo;
};

// x = hi + lo: hi is x rounded to TF32 to nearest, ties away from zero (as
// cvt.rna.tf32.f32, which sm_90 expands into about five instructions, less
// its NaN and infinity handling: the operands here are finite); lo = x - hi
// is exact, and the tensor cores read its leading TF32 bits, so x = hi + lo
// to within 2^-21 |x|. Three instructions.
__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// c (16x8, f32) += a (16x8, row) * b (8x8, col). Fragments, with g = lane/4
// and t = lane%4: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (t, g), b1 (t+4, g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 3xTF32: hh += a.hi*b.hi, hl += a.hi*b.lo, lh += a.lo*b.hi; the caller
// sums the three (or passes one accumulator three times). Separate
// accumulators make three short dependency chains of one long one.
// A_EXACT (B_EXACT): a's (b's) values are TF32 already (bf16 widened), its
// lo part is 0 and its term is dropped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&hh)[4], float (&hl)[4],
                                           float (&lh)[4], const Tf32x2 (&a)[4],
                                           const Tf32x2 (&b)[2]) {
  if constexpr (!A_EXACT)
    mma_tf32(lh, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if constexpr (!B_EXACT)
    mma_tf32(hl, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(hh, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// v's column c of a staged tile sits at slot c ^ ((c >> 2) & 3): the four
// columns 4 t + j (t = 0..3) that a B fragment reads at one k step land in
// four bank groups
__device__ __forceinline__ int vslot(int c) { return c ^ ((c >> 2) & 3); }

// floats a staged row of g takes (rows padded: the column sweep's B-fragment
// loads hit distinct banks)
__host__ __device__ constexpr int gpitch(int d) { return (d < 8 ? 8 : d) + 4; }

// ---------------------------------------------------------------------------
// the tile bodies
// ---------------------------------------------------------------------------

// One 32-column chunk (c0) of the forward's sweep of a tile, for thread
// (gq, tq) of the warp that owns rows r_lo and r_lo + 8 as the m16 side of
// P.V. In a 16-column window the k index t (t + 4) of k step hh is column
// 4 t + 2 hh (+1), so the thread's four columns of a window are one
// adjacency word. adj_s: the tile's adjacency, rows apitch bytes apart;
// ls_s: its ls; ck_s: its column halves of the dropout hash (DROP); v_s:
// its v, column c at vslot(c); vo: this thread's v columns of a window at
// k step hh. ld2: the rows' ld, m the running max (both in the log2
// domain), l this thread's part of the running sum, acc the hi.hi, hi.lo
// and lo.hi terms of P.V (PV; without it the same sweep with no product);
// row_key: the rows' halves of the dropout hash, kept iff the bits are
// below thresh. The logits are masked by one predicate and one select an
// element; the chunk's row max comes from two quad shuffles, (m, l, acc)
// are rescaled once, and the exps are ex2 on log2e-scaled logits. l takes
// the undropped p and acc the dropped one (reference order). mid() runs
// between the logits and the exps.
template <int D, typename VT, bool DROP, bool PV, typename Mid>
__device__ __forceinline__ void fwd_chunk(
    const unsigned char* adj_s, int apitch, const float* ls_s, const uint32_t* ck_s,
    const VT* v_s, const int (&vo)[2][2], int c0, int r_lo, int gq, int tq,
    const float (&ld2)[2], float slope, const uint32_t (&row_key)[2], uint32_t thresh,
    float (&m)[2], float (&l)[2], float (&acc)[3][(D + 7) / 8][4], Mid&& mid) {
  constexpr int ND = (D + 7) / 8;  // n8 tiles of the head dim
  constexpr bool V_EXACT = std::is_same<VT, __nv_bfloat16>::value;
  // z (log2 domain) of this thread's 8 columns c0 + 16 w + 4 tq + b of
  // the chunk, NEG2 off the edges: a select, no branch
  float z[2][8];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int c = c0 + 16 * w + 4 * tq;
    const float4 l4 = *reinterpret_cast<const float4*>(ls_s + c);
    const float lsv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const uint32_t bits =
          *reinterpret_cast<const uint32_t*>(adj_s + (r_lo + 8 * rr) * apitch + c);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float raw = fmaf(lsv[b], LOG2E, ld2[rr]);
        const float zz = fmaxf(raw, slope * raw);
        z[rr][4 * w + b] = (bits & (0xffu << (8 * b))) ? zz : NEG2;
      }
    }
  }
  mid();
  // the chunk's row max over the quad, one rescale, the exps; the
  // dropout keys of the 8 columns serve both rows
  uint32_t key[8];
  if constexpr (DROP) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const uint4 k4 = *reinterpret_cast<const uint4*>(ck_s + c0 + 16 * w + 4 * tq);
      key[4 * w] = k4.x;
      key[4 * w + 1] = k4.y;
      key[4 * w + 2] = k4.z;
      key[4 * w + 3] = k4.w;
    }
  }
  float p[2][8];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    // pairwise trees, not chains, for the max and the sum
    const float* zr = z[rr];
    float cm = fmaxf(fmaxf(fmaxf(zr[0], zr[1]), fmaxf(zr[2], zr[3])),
                     fmaxf(fmaxf(zr[4], zr[5]), fmaxf(zr[6], zr[7])));
    cm = fmaxf(cm, __shfl_xor_sync(FULL_MASK, cm, 1));
    cm = fmaxf(cm, __shfl_xor_sync(FULL_MASK, cm, 2));
    const float m_new = fmaxf(m[rr], cm);
    const float sc = ex2(m[rr] - m_new);
    m[rr] = m_new;
    float pu[8];  // the undropped p, for l
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // 0 off the edges once the row has one; before that the row's
      // sums are junk that the first edge's rescale (by 0) or the
      // finalize (no edge) discards
      pu[e] = ex2(zr[e] - m_new);
      p[rr][e] = pu[e];
      if constexpr (DROP) p[rr][e] = drop_tail(row_key[rr] ^ key[e]) < thresh ? pu[e] : 0.f;
    }
    const float ps = ((pu[0] + pu[1]) + (pu[2] + pu[3])) + ((pu[4] + pu[5]) + (pu[6] + pu[7]));
    l[rr] = fmaf(l[rr], sc, ps);
    if constexpr (PV) {
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int nt = 0; nt < ND; ++nt) {
          acc[x][nt][2 * rr] *= sc;
          acc[x][nt][2 * rr + 1] *= sc;
        }
    }
  }
  if constexpr (PV) {
    // acc += P.V: k step (w, hh) sums columns c0 + 16 w + 4 t + 2 hh + {0, 1}
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * w + 2 * hh;
        const Tf32x2 a[4] = {split_tf32(p[0][e]), split_tf32(p[1][e]),
                             split_tf32(p[0][e + 1]), split_tf32(p[1][e + 1])};
        const VT* va = v_s + (c0 + 16 * w) * D + vo[hh][0];
        const VT* vb = v_s + (c0 + 16 * w) * D + vo[hh][1];
#pragma unroll
        for (int nt = 0; nt < ND; ++nt) {
          const int d = 8 * nt + gq;
          Tf32x2 b[2] = {{0u, 0u}, {0u, 0u}};
          if (D >= 8 || d < D) {
            b[0] = split_tf32(to_f32(va[d]));
            b[1] = split_tf32(to_f32(vb[d]));
          }
          mma_3xtf32<false, V_EXACT>(acc[0][nt], acc[1][nt], acc[2][nt], a, b);
        }
      }
    }
  }
}

// One 8-row patch (rows i0 .. i0 + 7) of the column sweep of a tile, for
// thread (gq, tq) of the warp that owns columns j0 .. j0 + 3 (j0 = 32 cq +
// 4 gq) as the m side (m16 tiles 0 and 1: rows g and g + 8 are columns
// j0 + 2 tile and j0 + 2 tile + 1) of gv = V.G^T and of dv += C'.G. C's n
// index 2 t (2 t + 1) is row i0 + 2 t (+1), and dv's k index t (t + 4) the
// same row, so the g.v accumulator is the A operand of dv. adj_s: the
// tile's adjacency, rows apitch bytes apart; g_s: its g, rows gpitch(D)
// floats apart; ld_s, lse_s, delta_s and rk_s (the rows' halves of the
// dropout hash, DROP): its row vectors, row i at i - r0. va: v's split as
// the A operand of g.v (a0 (column j0 + 2 tile, d = t), a1 (j0 + 2 tile +
// 1, t), a2 (j0 + 2 tile, t + 4), a3 (j0 + 2 tile + 1, t + 4), d + 8 kk at
// k step kk); ls_j, col_key: the columns' ls and dropout halves; kept iff
// the bits are below thresh, scaled by scale. c is recomputed with ex2 on
// log2e-scaled logits and masked by a select, dz is folded with lrelu' by
// a select. Adds to dls_j and dv_acc; DLD: writes each of the two rows'
// sums of dz over the warp's 32 columns (shuffles over the 8 lanes of g)
// to dld_part (lanes gq == 0). mid() runs between the loads and the
// elements.
template <int D, typename VT, bool DROP, bool DLD, typename Mid>
__device__ __forceinline__ void bwd_col_patch(
    const unsigned char* adj_s, int apitch, const float* g_s, const float* ld_s,
    const float* lse_s, const float* delta_s, const uint32_t* rk_s, int r0, int i0, int j0,
    int gq, int tq, const Tf32x2 (&va)[2][(D + 7) / 8][4], const float (&ls_j)[4],
    const uint32_t (&col_key)[4], float slope, uint32_t thresh, float scale,
    float (&dls_j)[4], float (&dv_acc)[2][(D + 7) / 8][4], float* dld_part, Mid&& mid) {
  constexpr int KD = (D + 7) / 8;  // k8 steps (g.v) and n8 tiles (dv) of D
  constexpr int GP = gpitch(D);
  constexpr bool V_EXACT = std::is_same<VT, __nv_bfloat16>::value;
  // gv = V.G^T on rows i0 .. i0 + 7: b0 (d = t, row i0 + g), b1 (t + 4)
  Tf32x2 gb[KD][2];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const float* g_row = g_s + (i0 + gq) * GP + 8 * kk + tq;
    gb[kk][0] = split_tf32(g_row[0]);
    gb[kk][1] = split_tf32(D >= 8 ? g_row[4] : 0.f);
  }
  float gv[2][4];
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[tile][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      mma_3xtf32<V_EXACT, false>(gv[tile], gv[tile], gv[tile], va[tile][kk], gb[kk]);
  }
  // the elements: gv[tile][e] is column j0 + 2 tile + e / 2, row
  // ia + e % 2
  const int ia = i0 + 2 * tq;
  const float2 ld2 = *reinterpret_cast<const float2*>(ld_s + ia - r0);
  const float2 lse_n = *reinterpret_cast<const float2*>(lse_s + ia - r0);
  const float lse2[2] = {lse_n.x * LOG2E, lse_n.y * LOG2E};
  const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + ia - r0);
  const uint2 rk2 = DROP ? *reinterpret_cast<const uint2*>(rk_s + ia - r0) : make_uint2(0u, 0u);
  const uint32_t adj[2] = {*reinterpret_cast<const uint32_t*>(adj_s + ia * apitch + j0),
                           *reinterpret_cast<const uint32_t*>(adj_s + (ia + 1) * apitch + j0)};
  mid();
  float cd[2][4], row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j4 = 2 * tile + (e >> 1), rr = e & 1;
      const float raw = (rr ? ld2.y : ld2.x) + ls_j[j4];
      const float zz = fmaxf(raw, slope * raw);
      const float ce = ex2(fmaf(zz, LOG2E, -lse2[rr]));
      // a select, not a multiply: off-edge ce may be +inf
      const float c = (adj[rr] & (0xffu << (8 * j4))) ? ce : 0.f;
      float c_agg = c;
      if constexpr (DROP)
        c_agg = drop_tail((rr ? rk2.y : rk2.x) ^ col_key[j4]) < thresh ? c * scale : 0.f;
      const float dz = fmaf(c_agg, gv[tile][e], -c * (rr ? dl2.y : dl2.x));
      const float dzs = raw >= 0.f ? dz : slope * dz;
      dls_j[j4] += dzs;
      row_sum[rr] += dzs;
      cd[tile][e] = c_agg;
    }
  }
  // dv += C'.G: a = (cd0, cd2, cd1, cd3), b0 (row ia, d = 8 nt + g),
  // b1 (row ia + 1)
  Tf32x2 gr[KD][2];
#pragma unroll
  for (int nt = 0; nt < KD; ++nt) {
    const int d = 8 * nt + gq;
    const bool in = D >= 8 || d < D;
    gr[nt][0] = split_tf32(in ? g_s[ia * GP + d] : 0.f);
    gr[nt][1] = split_tf32(in ? g_s[(ia + 1) * GP + d] : 0.f);
  }
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    const Tf32x2 a[4] = {split_tf32(cd[tile][0]), split_tf32(cd[tile][2]),
                         split_tf32(cd[tile][1]), split_tf32(cd[tile][3])};
#pragma unroll
    for (int nt = 0; nt < KD; ++nt)
      mma_3xtf32<false, false>(dv_acc[tile][nt], dv_acc[tile][nt], dv_acc[tile][nt], a, gr[nt]);
  }
  if constexpr (DLD) {
    // rows ia, ia + 1 over the warp's 32 columns (the 8 lanes of g)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = row_sum[rr];
      x += __shfl_xor_sync(FULL_MASK, x, 4);
      x += __shfl_xor_sync(FULL_MASK, x, 8);
      x += __shfl_xor_sync(FULL_MASK, x, 16);
      if (gq == 0) dld_part[ia + rr] = x;
    }
  }
}

// The dynamic shared memory a block needs, and the largest shared-memory
// carveout of the SM's L1, so that as many blocks fit as registers allow.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, or the next launch's check reports it
  return err;
}

}  // namespace
