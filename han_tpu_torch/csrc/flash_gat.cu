// Block-sparse flash-GAT kernels for Hopper (sm_90a): the forward, the fused
// backward, and the split backward (row sweep + column sweep) of masked
// graph attention over the occupied tiles of a BCSRGraph
// (han_tpu_torch/graph/bcsr.py) or of one strip or ring cell of a
// partitioned graph (han_tpu_torch/parallel/). Plain C interface, bound with
// ctypes by han_tpu_torch/ops/flash_gat.py, which also holds the plain
// PyTorch version of each kernel.
//
// Replaces (han_tpu/ops/pallas/flash_gat.py):
//   fwd_kernel      <- _fwd_kernel (l.97), the rectangular (nb_r, c_max)
//                      grid, and _fwd_kernel_flat (l.187), its flat step
//                      list, with _fwd_tile_compute (l.126) and
//                      _fwd_finalize (l.175): one block per row block walks
//                      that block's occupied tiles, so the two TPU grids
//                      are one kernel here
//   bwd_col_kernel  <- _bwd_col_kernel (l.395) with _head_dz (l.331), and
//                      like it with a fuse_dld switch (the FUSE_DLD template
//                      argument): <true> is the fused backward
//                      (han_flash_bwd), <false> the split backward's column
//                      sweep, dls and dv only, no atomics (han_flash_bwd_col)
//   bwd_row_kernel  <- _bwd_row_kernel (l.354): dld only
//   drop_bits       <- _tile_drop_keep (l.71)
//
// The row and column domains are separate (n_rows x n_cols): a graph-axis
// shard sweeps its strip of local rows against the global columns, a ring
// step one (n_loc x n_loc) cell; the meta offsets (row block, head, column
// block) make every dropout key global.
//
// Math, per head h (ld = logit_dst, ls = logit_src, v = features):
//   z_ij   = leaky_relu(ld_i + ls_j) on edges
//   out_i  = sum_j softmax_j(z_ij) * keep_ij * v_j,  lse_i = logsumexp_j z_ij
//   c_ij   = exp(z_ij - lse_i) on edges, 0 off them; c'_ij = c_ij * keep_ij
//   dz_ij  = (c'_ij (g_i . v_j) - c_ij delta_i) * lrelu'(raw_ij),
//            delta_i = g_i . out_i (formed in torch before the launch)
//   dld_i  = sum_j dz_ij,  dls_j = sum_i dz_ij,  dv_j = sum_i c'_ij g_i
// The softmax denominator uses the undropped p and the accumulator the
// dropped one (reference order); rows without edges give out = 0 and
// lse = -1e9. v may be f32 or bf16 (the VT template argument, as
// han_tpu/ops/pallas/flash_gat.py:749-758 streams bf16 features): it is
// widened to f32 right after each load, and everything else, dv included,
// is f32.
//
// What bounds it on the H100, and what the design does about it:
// - The work is elementwise over the swept tile area (bm*bn*K per occupied
//   tile: a compare, an exp, a hash when dropout is on, and D FMAs), with
//   D = 8 far too narrow for tensor cores. The adjacency, the largest
//   stream, is 1 byte per element and is reused by every row's D-wide
//   dot, so the kernels are bound by issue rate and latency, not by HBM.
//   Parallelism is the lever: TPR threads share each tile row (forward,
//   row sweep) or column (backward, column sweep), each taking a slice and
//   keeping its own partial sums, merged through shared memory at the end.
//   That gives N*K*TPR threads (131K at the DBLP shape) instead of N*K.
// - The TPU grid ran in order and carried m/l/acc and the resident dld
//   window across steps. Here blocks run in parallel: a loop inside the
//   block walks the row block's (or column block's) occupied tiles and the
//   running sums live in registers. In the fused backward dld, a sum across
//   column blocks, goes through atomicAdd into a zeroed buffer (summation
//   order varies from run to run). The split backward needs no atomic: the
//   row sweep gives each (row block, head) to one block, the column sweep
//   each (column block, head), each thread sums its slice in tile order and
//   the TPR slices merge in thread order, so both are bitwise reproducible
//   (the path torch.use_deterministic_algorithms(True) takes). They pay for
//   it by recomputing c and dz in both sweeps.
// - One block per (tile row or column block, head): the TPU fused the K
//   heads to read each adjacency tile once from HBM; here the K blocks of a
//   tile re-read it from the 50 MB L2, which holds a DBLP meta-path's tiles.
// - Each step stages the adjacency tile, the ls/ld slices and the v or g
//   slice in shared memory. The row-major kernels pad each staged
//   adjacency row by one word, so the 32 rows of a warp hit 32 banks.
// - Dropout is a counter-based hash of (seed, global row, global column,
//   global head), so the backward replays the forward's mask without
//   storing it, the mask does not depend on the tile size, and the meta
//   offsets (row block, head, column block) keep it global for sharded runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TPR = 4;  // threads per tile row (fwd) / tile column (bwd)
constexpr float NEG_INIT = -1e9f;  // = MASK_VALUE
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Drop {
  int on;
  uint32_t seed;
  uint32_t thresh;  // keep iff bits < thresh = floor((1 - p) * 2^32)
  float scale;      // 1 / (1 - p)
};

struct Offsets {
  int row_block;
  int head;
  int col_block;
};

// murmur3 finalizer; ops/flash_gat.py:_fmix32 is the same function on int64
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t drop_head_key(uint32_t seed, uint32_t head) {
  return fmix32(seed ^ fmix32(head + 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t drop_row_key(uint32_t head_key, uint32_t row) {
  return fmix32(head_key ^ row);
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t row_key, uint32_t col) {
  return fmix32(row_key ^ (col * 0x9E3779B9u));
}

// v is float or bf16 (VT); it is widened to f32 in registers right after the
// load, and everything else computes and accumulates in f32
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// forward: block (row block rb, head h); thread (r, q) owns tile row r and
// the q-th quarter of every tile's columns.
// ---------------------------------------------------------------------------

template <int D, typename VT>
__global__ void __launch_bounds__(1024) fwd_kernel(
    const int8_t* __restrict__ tiles, const int* __restrict__ fcount,
    const int* __restrict__ fcol, const int* __restrict__ ftile, int c_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int n_rows, int n_cols, int bm, int bn, int k,
    float slope, Drop drop, Offsets off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = bn / 4;      // int32 words per tile row
  const int wpitch = words + 1;  // +1: row r starts at bank r
  uint32_t* adj_s = reinterpret_cast<uint32_t*>(smem);  // [bm][wpitch]
  float* ls_s = reinterpret_cast<float*>(adj_s + bm * wpitch);  // [bn]
  float* v_s = ls_s + bn;                                       // [bn][D]
  float* red_s = v_s + bn * D;  // [TPR][bm] m, [TPR][bm] l, [TPR][bm][D] acc

  const int rb = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int r = tid % bm, q = tid / bm;  // bm % 32 == 0: q is warp-uniform
  const int row = rb * bm + r;
  const int kd = k * D;
  const int cw = words / TPR;  // words in this thread's column slice
  const int j0 = q * cw * 4;   // first column of the slice
  const float ld_r = ld[(size_t)h * n_rows + row];
  const uint32_t row_key =
      drop.on ? drop_row_key(drop_head_key(drop.seed, off.head + h),
                             (uint32_t)((off.row_block + rb) * bm + r))
              : 0u;

  float m = NEG_INIT, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const int count = fcount[rb];
  for (int s = 0; s < count; ++s) {
    const int cb = fcol[rb * c_pitch + s];
    const int t = ftile[rb * c_pitch + s];
    __syncthreads();  // the previous tile is consumed
    const uint32_t* tile_w =
        reinterpret_cast<const uint32_t*>(tiles + (size_t)t * bm * bn);
    for (int i = tid; i < bm * words; i += nthr) {
      const int rr = i / words;
      adj_s[rr * wpitch + (i - rr * words)] = tile_w[i];
    }
    for (int j = tid; j < bn; j += nthr)
      ls_s[j] = ls[(size_t)h * n_cols + (size_t)cb * bn + j];
    for (int i = tid; i < bn * D; i += nthr) {
      const int j = i / D;
      v_s[i] = to_f32(v[((size_t)cb * bn + j) * kd + h * D + (i - j * D)]);
    }
    __syncthreads();

    const uint32_t* my = adj_s + r * wpitch + q * cw;
    float cmax = NEG_INIT;
    for (int w = 0; w < cw; ++w) {
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
    if (cmax == NEG_INIT) continue;  // no edge in this slice of the tile

    const float m_new = fmaxf(m, cmax);
    const float scale = expf(m - m_new);
    l *= scale;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= scale;
    const uint32_t col0 = (uint32_t)((off.col_block + cb) * bn + j0);
    for (int w = 0; w < cw; ++w) {
      const uint32_t bits = my[w];
      if (!bits) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((bits >> (8 * b)) & 0xffu) {
          const int j = j0 + 4 * w + b;
          const float raw = ld_r + ls_s[j];
          float p = expf(fmaxf(raw, slope * raw) - m_new);
          l += p;
          if (drop.on)
            p = drop_bits(row_key, col0 + 4 * w + b) < drop.thresh
                    ? p * drop.scale : 0.f;
          const float* vj = v_s + j * D;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
        }
      }
    }
    m = m_new;
  }

  // merge the TPR slices of row r
  float* m_s = red_s;
  float* l_s = red_s + TPR * bm;
  float* a_s = red_s + 2 * TPR * bm;
  __syncthreads();
  m_s[q * bm + r] = m;
  l_s[q * bm + r] = l;
#pragma unroll
  for (int d = 0; d < D; ++d) a_s[(q * bm + r) * D + d] = acc[d];
  __syncthreads();
  if (q != 0) return;
  float mx = NEG_INIT;
#pragma unroll
  for (int qq = 0; qq < TPR; ++qq) mx = fmaxf(mx, m_s[qq * bm + r]);
  float sum = 0.f, o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
#pragma unroll
  for (int qq = 0; qq < TPR; ++qq) {
    const float f = expf(m_s[qq * bm + r] - mx);
    sum += l_s[qq * bm + r] * f;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] += a_s[(qq * bm + r) * D + d] * f;
  }
  const bool has_edge = mx > 0.5f * NEG_INIT;
  const float lsum = fmaxf(sum, 1e-30f);
  const float inv = has_edge ? 1.f / lsum : 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) out[(size_t)row * kd + h * D + d] = o[d] * inv;
  lse[(size_t)h * n_rows + row] = has_edge ? mx + logf(lsum) : NEG_INIT;
}

// ---------------------------------------------------------------------------
// backward column sweep: block (column block cb, head h); thread (j, q) owns
// tile column j and the q-th quarter of every tile's rows. Writes dls and dv
// once per column. FUSE_DLD (the fused backward) also sums dld: per tile
// into shared memory, then across column blocks with atomicAdd into the
// zeroed global buffer. Without it (the split backward's column sweep) the
// kernel has no atomic at all.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

template <int D, bool FUSE_DLD, typename VT>
__global__ void __launch_bounds__(1024) bwd_col_kernel(
    const int8_t* __restrict__ tiles, const int* __restrict__ bcount,
    const int* __restrict__ brow, const int* __restrict__ btile, int r_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dld, float* __restrict__ dls, float* __restrict__ dv,
    int n_rows, int n_cols, int bm, int bn, int k, float slope, Drop drop,
    Offsets off) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* adj_s = smem;                                     // [bm][bn]
  float* ld_s = reinterpret_cast<float*>(smem + bm * bn);    // [bm]
  float* lse_s = ld_s + bm;                                  // [bm]
  float* delta_s = lse_s + bm;                               // [bm]
  float* g_s = delta_s + bm;                                 // [bm][D]
  float* red_s = g_s + bm * D;  // [TPR][bn] dls, [TPR][bn][D] dv
  float* dld_s = red_s + TPR * bn * (D + 1);  // [bm], FUSE_DLD only

  const int cb = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid % bn, q = tid / bn;  // bn % 32 == 0: q is warp-uniform
  const int lane = tid & 31;
  const int col = cb * bn + j;
  const int kd = k * D;
  const int rc = bm / TPR;  // rows in this thread's slice
  const float ls_j = ls[(size_t)h * n_cols + col];
  float v_j[D], dv_j[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v_j[d] = to_f32(v[(size_t)col * kd + h * D + d]);
    dv_j[d] = 0.f;
  }
  float dls_j = 0.f;
  const uint32_t head_key = drop.on ? drop_head_key(drop.seed, off.head + h) : 0u;
  const uint32_t gcol = (uint32_t)((off.col_block + cb) * bn + j);

  if constexpr (FUSE_DLD)
    for (int i = tid; i < bm; i += nthr) dld_s[i] = 0.f;
  const int count = bcount[cb];
  int prev_rb = 0;
  for (int s = 0; s < count; ++s) {
    const int rb = brow[cb * r_pitch + s];
    const int t = btile[cb * r_pitch + s];
    __syncthreads();  // the previous tile (and its dld partials) is complete
    if constexpr (FUSE_DLD) {
      if (s > 0) {
        for (int i = tid; i < bm; i += nthr) {
          atomicAdd(&dld[(size_t)h * n_rows + (size_t)prev_rb * bm + i], dld_s[i]);
          dld_s[i] = 0.f;
        }
      }
    }
    const uint4* tile_v = reinterpret_cast<const uint4*>(tiles + (size_t)t * bm * bn);
    uint4* adj_v = reinterpret_cast<uint4*>(adj_s);
    for (int i = tid; i < bm * bn / 16; i += nthr) adj_v[i] = tile_v[i];
    for (int i = tid; i < bm; i += nthr) {
      const size_t hr = (size_t)h * n_rows + (size_t)rb * bm + i;
      ld_s[i] = ld[hr];
      lse_s[i] = lse[hr];
      delta_s[i] = delta[hr];
    }
    for (int i = tid; i < bm * D; i += nthr) {
      const int ii = i / D;
      g_s[i] = g[((size_t)rb * bm + ii) * kd + h * D + (i - ii * D)];
    }
    __syncthreads();

    const uint32_t row0 = (uint32_t)((off.row_block + rb) * bm);
    for (int ii = 0; ii < rc; ++ii) {
      const int i = q * rc + ii;
      const bool on_edge = adj_s[i * bn + j] != 0;
      float dzs = 0.f;
      if (on_edge) {
        const float raw = ld_s[i] + ls_j;
        const float c = expf(fmaxf(raw, slope * raw) - lse_s[i]);
        float c_agg = c;
        if (drop.on)
          c_agg = drop_bits(drop_row_key(head_key, row0 + i), gcol) < drop.thresh
                      ? c * drop.scale : 0.f;
        const float* g_i = g_s + i * D;
        float gv = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) gv = fmaf(g_i[d], v_j[d], gv);
        const float dz = c_agg * gv - c * delta_s[i];
        dzs = raw >= 0.f ? dz : slope * dz;
        dls_j += dzs;
#pragma unroll
        for (int d = 0; d < D; ++d) dv_j[d] = fmaf(c_agg, g_i[d], dv_j[d]);
      }
      if constexpr (FUSE_DLD) {
        if (__any_sync(FULL_MASK, on_edge)) {  // warp-uniform: the row i
          const float rs = warp_sum(dzs);      // is the same on all lanes
          if (lane == 0) atomicAdd(&dld_s[i], rs);
        }
      }
    }
    prev_rb = rb;
  }
  if constexpr (FUSE_DLD) {
    __syncthreads();
    if (count > 0) {
      for (int i = tid; i < bm; i += nthr)
        atomicAdd(&dld[(size_t)h * n_rows + (size_t)prev_rb * bm + i], dld_s[i]);
    }
  }

  // merge the TPR slices of column j in thread order; written once
  float* s_s = red_s;
  float* a_s = red_s + TPR * bn;
  s_s[q * bn + j] = dls_j;
#pragma unroll
  for (int d = 0; d < D; ++d) a_s[(q * bn + j) * D + d] = dv_j[d];
  __syncthreads();
  if (q != 0) return;
  float sum = 0.f, o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
#pragma unroll
  for (int qq = 0; qq < TPR; ++qq) {
    sum += s_s[qq * bn + j];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] += a_s[(qq * bn + j) * D + d];
  }
  dls[(size_t)h * n_cols + col] = sum;
#pragma unroll
  for (int d = 0; d < D; ++d) dv[(size_t)col * kd + h * D + d] = o[d];
}

// ---------------------------------------------------------------------------
// split backward, row sweep: block (row block rb, head h) over the forward
// map; thread (r, q) owns tile row r and the q-th quarter of every tile's
// columns, as in fwd_kernel. Writes dld only, once per row: no atomics.
// ---------------------------------------------------------------------------

template <int D, typename VT>
__global__ void __launch_bounds__(1024) bwd_row_kernel(
    const int8_t* __restrict__ tiles, const int* __restrict__ fcount,
    const int* __restrict__ fcol, const int* __restrict__ ftile, int c_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dld, int n_rows, int n_cols, int bm, int bn, int k,
    float slope, Drop drop, Offsets off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = bn / 4;      // int32 words per tile row
  const int wpitch = words + 1;  // +1: row r starts at bank r
  uint32_t* adj_s = reinterpret_cast<uint32_t*>(smem);  // [bm][wpitch]
  float* ls_s = reinterpret_cast<float*>(adj_s + bm * wpitch);  // [bn]
  float* v_s = ls_s + bn;                                       // [bn][D]
  float* red_s = v_s + bn * D;                                  // [TPR][bm]

  const int rb = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int r = tid % bm, q = tid / bm;  // bm % 32 == 0: q is warp-uniform
  const int row = rb * bm + r;
  const int kd = k * D;
  const int cw = words / TPR;  // words in this thread's column slice
  const int j0 = q * cw * 4;   // first column of the slice
  const size_t hr = (size_t)h * n_rows + row;
  const float ld_r = ld[hr], lse_r = lse[hr], delta_r = delta[hr];
  float g_r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) g_r[d] = g[(size_t)row * kd + h * D + d];
  const uint32_t row_key =
      drop.on ? drop_row_key(drop_head_key(drop.seed, off.head + h),
                             (uint32_t)((off.row_block + rb) * bm + r))
              : 0u;

  float acc = 0.f;
  const int count = fcount[rb];
  for (int s = 0; s < count; ++s) {
    const int cb = fcol[rb * c_pitch + s];
    const int t = ftile[rb * c_pitch + s];
    __syncthreads();  // the previous tile is consumed
    const uint32_t* tile_w =
        reinterpret_cast<const uint32_t*>(tiles + (size_t)t * bm * bn);
    for (int i = tid; i < bm * words; i += nthr) {
      const int rr = i / words;
      adj_s[rr * wpitch + (i - rr * words)] = tile_w[i];
    }
    for (int j = tid; j < bn; j += nthr)
      ls_s[j] = ls[(size_t)h * n_cols + (size_t)cb * bn + j];
    for (int i = tid; i < bn * D; i += nthr) {
      const int j = i / D;
      v_s[i] = to_f32(v[((size_t)cb * bn + j) * kd + h * D + (i - j * D)]);
    }
    __syncthreads();

    const uint32_t* my = adj_s + r * wpitch + q * cw;
    const uint32_t col0 = (uint32_t)((off.col_block + cb) * bn + j0);
    for (int w = 0; w < cw; ++w) {
      const uint32_t bits = my[w];
      if (!bits) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((bits >> (8 * b)) & 0xffu) {
          const int j = j0 + 4 * w + b;
          const float raw = ld_r + ls_s[j];
          const float c = expf(fmaxf(raw, slope * raw) - lse_r);
          float c_agg = c;
          if (drop.on)
            c_agg = drop_bits(row_key, col0 + 4 * w + b) < drop.thresh
                        ? c * drop.scale : 0.f;
          const float* vj = v_s + j * D;
          float gv = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) gv = fmaf(g_r[d], vj[d], gv);
          const float dz = c_agg * gv - c * delta_r;
          acc += raw >= 0.f ? dz : slope * dz;
        }
      }
    }
  }

  // merge the TPR slices of row r in thread order
  red_s[q * bm + r] = acc;
  __syncthreads();
  if (q != 0) return;
  float sum = 0.f;
#pragma unroll
  for (int qq = 0; qq < TPR; ++qq) sum += red_s[qq * bm + r];
  dld[hr] = sum;
}

bool bad_geometry(int n_rows, int n_cols, int bm, int bn, int k) {
  return bm <= 0 || bn <= 0 || bm % 32 || bn % 32 || bm * TPR > 1024 ||
         bn * TPR > 1024 || n_rows % bm || n_cols % bn || k <= 0;
}

size_t fwd_smem(int bm, int bn, int d) {
  return (size_t)bm * (bn / 4 + 1) * 4 + (size_t)bn * 4 + (size_t)bn * d * 4 +
         (size_t)TPR * bm * (d + 2) * 4;
}

size_t bwd_smem(int bm, int bn, int d, bool fuse_dld) {
  return (size_t)bm * bn + (size_t)bm * (3 + fuse_dld + d) * 4 +
         (size_t)TPR * bn * (d + 1) * 4;
}

size_t row_smem(int bm, int bn, int d) {
  return (size_t)bm * (bn / 4 + 1) * 4 + (size_t)bn * 4 + (size_t)bn * d * 4 +
         (size_t)TPR * bm * 4;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, typename VT>
int launch_fwd(const void* tiles, const void* fcount, const void* fcol,
               const void* ftile, int c_pitch, const void* ld, const void* ls,
               const void* v, void* out, void* lse, int n_rows, int n_cols,
               int bm, int bn, int k, float slope, Drop drop, Offsets off,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(bm, bn, D);
  cudaError_t err = set_smem(fwd_kernel<D, VT>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<D, VT><<<dim3(n_rows / bm, k), bm * TPR, smem, stream>>>(
      (const int8_t*)tiles, (const int*)fcount, (const int*)fcol,
      (const int*)ftile, c_pitch, (const float*)ld, (const float*)ls,
      (const VT*)v, (float*)out, (float*)lse, n_rows, n_cols, bm, bn, k,
      slope, drop, off);
  return (int)cudaGetLastError();
}

template <int D, bool FUSE_DLD, typename VT>
int launch_bwd(const void* tiles, const void* bcount, const void* brow,
               const void* btile, int r_pitch, const void* ld, const void* ls,
               const void* v, const void* g, const void* lse,
               const void* delta, void* dld, void* dls, void* dv, int n_rows,
               int n_cols, int bm, int bn, int k, float slope, Drop drop,
               Offsets off, cudaStream_t stream) {
  const size_t smem = bwd_smem(bm, bn, D, FUSE_DLD);
  cudaError_t err = set_smem(bwd_col_kernel<D, FUSE_DLD, VT>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_col_kernel<D, FUSE_DLD, VT><<<dim3(n_cols / bn, k), bn * TPR, smem, stream>>>(
      (const int8_t*)tiles, (const int*)bcount, (const int*)brow,
      (const int*)btile, r_pitch, (const float*)ld, (const float*)ls,
      (const VT*)v, (const float*)g, (const float*)lse,
      (const float*)delta, (float*)dld, (float*)dls, (float*)dv, n_rows,
      n_cols, bm, bn, k, slope, drop, off);
  return (int)cudaGetLastError();
}

template <int D, typename VT>
int launch_bwd_row(const void* tiles, const void* fcount, const void* fcol,
                   const void* ftile, int c_pitch, const void* ld,
                   const void* ls, const void* v, const void* g,
                   const void* lse, const void* delta, void* dld, int n_rows,
                   int n_cols, int bm, int bn, int k, float slope, Drop drop,
                   Offsets off, cudaStream_t stream) {
  const size_t smem = row_smem(bm, bn, D);
  cudaError_t err = set_smem(bwd_row_kernel<D, VT>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_row_kernel<D, VT><<<dim3(n_rows / bm, k), bm * TPR, smem, stream>>>(
      (const int8_t*)tiles, (const int*)fcount, (const int*)fcol,
      (const int*)ftile, c_pitch, (const float*)ld, (const float*)ls,
      (const VT*)v, (const float*)g, (const float*)lse,
      (const float*)delta, (float*)dld, n_rows, n_cols, bm, bn, k, slope,
      drop, off);
  return (int)cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(dim, tag) with the head dim d (4, 8 or 16) as an
// std::integral_constant and v's element type (float, or bf16 when v_bf16)
// as a Tag.
template <typename F>
int dispatch(int d, int v_bf16, F&& f) {
  auto by_type = [&](auto dim) {
    return v_bf16 ? f(dim, Tag<__nv_bfloat16>{}) : f(dim, Tag<float>{});
  };
  switch (d) {
    case 4: return by_type(std::integral_constant<int, 4>{});
    case 8: return by_type(std::integral_constant<int, 8>{});
    case 16: return by_type(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The column sweep, with or without the fused dld.
template <bool FUSE_DLD>
int bwd_entry(const void* tiles, const void* bcount, const void* brow,
              const void* btile, int r_pitch, const void* ld, const void* ls,
              const void* v, const void* g, const void* lse,
              const void* delta, void* dld, void* dls, void* dv, int n_rows,
              int n_cols, int bm, int bn, int k, int d, int v_bf16,
              float slope, int drop_on, unsigned seed, unsigned thresh,
              float drop_scale, int row_block_off, int head_off,
              int col_block_off, void* stream) {
  if (bad_geometry(n_rows, n_cols, bm, bn, k)) return (int)cudaErrorInvalidValue;
  const Drop drop{drop_on, seed, thresh, drop_scale};
  const Offsets off{row_block_off, head_off, col_block_off};
  return dispatch(d, v_bf16, [&](auto dim, auto tag) {
    return launch_bwd<decltype(dim)::value, FUSE_DLD, typename decltype(tag)::type>(
        tiles, bcount, brow, btile, r_pitch, ld, ls, v, g, lse, delta, dld, dls,
        dv, n_rows, n_cols, bm, bn, k, slope, drop, off, (cudaStream_t)stream);
  });
}

}  // namespace

extern "C" {

// Forward. tiles int8 [T, bm, bn]; fcount int32 [nb_r]; fcol, ftile int32
// [nb_r, c_pitch]; ld f32 [k, n_rows]; ls f32 [k, n_cols]; v f32, or bf16
// when v_bf16, [n_cols, k*d] -> out f32 [n_rows, k*d], lse f32 [k, n_rows].
// Returns a cudaError_t code (0 = launched).
int han_flash_fwd(const void* tiles, const void* fcount, const void* fcol,
                  const void* ftile, int c_pitch, const void* ld,
                  const void* ls, const void* v, void* out, void* lse,
                  int n_rows, int n_cols, int bm, int bn, int k, int d,
                  int v_bf16, float slope, int drop_on, unsigned seed,
                  unsigned thresh, float drop_scale, int row_block_off,
                  int head_off, int col_block_off, void* stream) {
  if (bad_geometry(n_rows, n_cols, bm, bn, k)) return (int)cudaErrorInvalidValue;
  const Drop drop{drop_on, seed, thresh, drop_scale};
  const Offsets off{row_block_off, head_off, col_block_off};
  return dispatch(d, v_bf16, [&](auto dim, auto tag) {
    return launch_fwd<decltype(dim)::value, typename decltype(tag)::type>(
        tiles, fcount, fcol, ftile, c_pitch, ld, ls, v, out, lse, n_rows,
        n_cols, bm, bn, k, slope, drop, off, (cudaStream_t)stream);
  });
}

// Fused backward. Adds bcount int32 [nb_c]; brow, btile int32 [nb_c, r_pitch];
// g f32 [n_rows, k*d]; lse, delta f32 [k, n_rows] -> dld f32 [k, n_rows]
// (zeroed by the caller, accumulated with atomicAdd), dls f32 [k, n_cols],
// dv f32 [n_cols, k*d] (written once; f32 whatever v's type).
int han_flash_bwd(const void* tiles, const void* bcount, const void* brow,
                  const void* btile, int r_pitch, const void* ld,
                  const void* ls, const void* v, const void* g,
                  const void* lse, const void* delta, void* dld, void* dls,
                  void* dv, int n_rows, int n_cols, int bm, int bn, int k,
                  int d, int v_bf16, float slope, int drop_on, unsigned seed,
                  unsigned thresh, float drop_scale, int row_block_off,
                  int head_off, int col_block_off, void* stream) {
  return bwd_entry<true>(tiles, bcount, brow, btile, r_pitch, ld, ls, v, g,
                         lse, delta, dld, dls, dv, n_rows, n_cols, bm, bn, k,
                         d, v_bf16, slope, drop_on, seed, thresh, drop_scale,
                         row_block_off, head_off, col_block_off, stream);
}

// Split backward, row sweep: the forward's map and the fused backward's
// float inputs -> dld f32 [k, n_rows], each element written once.
int han_flash_bwd_row(const void* tiles, const void* fcount, const void* fcol,
                      const void* ftile, int c_pitch, const void* ld,
                      const void* ls, const void* v, const void* g,
                      const void* lse, const void* delta, void* dld,
                      int n_rows, int n_cols, int bm, int bn, int k, int d,
                      int v_bf16, float slope, int drop_on, unsigned seed,
                      unsigned thresh, float drop_scale, int row_block_off,
                      int head_off, int col_block_off, void* stream) {
  if (bad_geometry(n_rows, n_cols, bm, bn, k)) return (int)cudaErrorInvalidValue;
  const Drop drop{drop_on, seed, thresh, drop_scale};
  const Offsets off{row_block_off, head_off, col_block_off};
  return dispatch(d, v_bf16, [&](auto dim, auto tag) {
    return launch_bwd_row<decltype(dim)::value, typename decltype(tag)::type>(
        tiles, fcount, fcol, ftile, c_pitch, ld, ls, v, g, lse, delta, dld,
        n_rows, n_cols, bm, bn, k, slope, drop, off, (cudaStream_t)stream);
  });
}

// Split backward, column sweep: the backward's map and the same float
// inputs -> dls f32 [k, n_cols], dv f32 [n_cols, k*d], each written once.
int han_flash_bwd_col(const void* tiles, const void* bcount, const void* brow,
                      const void* btile, int r_pitch, const void* ld,
                      const void* ls, const void* v, const void* g,
                      const void* lse, const void* delta, void* dls, void* dv,
                      int n_rows, int n_cols, int bm, int bn, int k, int d,
                      int v_bf16, float slope, int drop_on, unsigned seed,
                      unsigned thresh, float drop_scale, int row_block_off,
                      int head_off, int col_block_off, void* stream) {
  return bwd_entry<false>(tiles, bcount, brow, btile, r_pitch, ld, ls, v, g,
                          lse, delta, nullptr, dls, dv, n_rows, n_cols, bm, bn,
                          k, d, v_bf16, slope, drop_on, seed, thresh,
                          drop_scale, row_block_off, head_off, col_block_off,
                          stream);
}

const char* han_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
