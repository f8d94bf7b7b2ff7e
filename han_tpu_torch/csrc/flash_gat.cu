// Block-sparse flash-GAT kernels for Hopper (sm_90a): the forward, the fused
// backward, and the split backward (row sweep + column sweep) of masked
// graph attention over the occupied tiles of a BCSRGraph
// (han_tpu_torch/graph/bcsr.py) or of one strip or ring cell of a
// partitioned graph (han_tpu_torch/parallel/). Plain C interface, bound with
// ctypes by han_tpu_torch/ops/flash_gat.py, which also holds the plain
// PyTorch version of each kernel. The tile bodies of the forward and the
// column sweep (fwd_chunk, bwd_col_patch) and their device helpers (ex2, the
// 3xTF32 products, the v and g swizzles) are in csrc/tile_mma.cuh, which
// csrc/calibrate.cu's strip bodies share; the wide bodies of the forward
// and the fused backward (fwd_wide, bwd_wide) take their products through
// csrc/wgmma.cuh.
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
//   bwd_row_kernel  <- _bwd_row_kernel (l.354): dld only, the forward's
//                      sweep with g.v^T in place of P.V
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
// widened to f32 after each load, and everything else, dv included, is f32.
//
// What bounds the kernels on the H100, and what their design does about it:
// - The work is elementwise over the swept tile area (bm*bn*K per occupied
//   tile), not over the edges: at DBLP's density (0.40-0.56 inside an
//   occupied tile) almost every warp meets an edge at almost every element,
//   so a branch per adjacency byte buys nothing and serializes dependent
//   chains. The kernels are bound by instruction issue (their time grows
//   linearly with the heads from 8 to 32, so more resident warps do not
//   help): the sweep is branch-free, the adjacency selects (one predicate
//   and one select an element), the compiler interleaves independent
//   elements, and every per-element instruction that could move to a row,
//   a column or a tile did.
// - The D-wide products run on the tensor cores: each warp holds a 16-row
//   (forward, row sweep) or 2 x 16-column (column sweep) strip of the block
//   in the register layout of mma.sync.m16n8k8 (TF32), computes the logits,
//   exps and masks in the accumulator/operand fragments themselves, and
//   permutes the summation index of each product (as FlashAttention-2 does)
//   so that a thread's columns are contiguous (one 32-bit word of 4
//   adjacency bytes a row) and the accumulator of g.v serves as the A
//   operand of dv with no trip through shared memory; the row sweep permutes
//   the n index of g.v^T instead, so that its product lands on the
//   forward's logit positions. 3xTF32 (hi.hi + hi.lo + lo.hi, hi rounded
//   to TF32, lo the remainder as the tensor cores read it) keeps the
//   products within about 2^-20 of f32 ones; a bf16 v has no lo part, so
//   its term is dropped.
// - The forward sweeps each tile once: the row max of a 32-column chunk is
//   taken over the fragment with two quad shuffles, the running (m, l, acc)
//   are rescaled once per chunk, exps are exp2 on log2e-scaled logits.
// - Staging is asynchronous and double-buffered: cp.async copies tile s+1's
//   adjacency (rows padded by 16 bytes: the rows a warp reads hit distinct
//   banks), logit slices and v or g slice while tile s computes, behind one
//   barrier a tile. The adjacency goes in parts, one 16-byte chunk a thread
//   per 32-column chunk (forward) or 8-row patch (backward) of tile s,
//   between its shared-memory loads: issued all at once, the copies held
//   up those loads. v's
//   columns are swizzled (vslot; row_vswz for the row sweep's other read
//   pattern) and g's rows padded (gpitch) so that the B-fragment loads hit
//   distinct banks. The int8 tiles stay as BCSRGraph
//   holds them.
// - Dropout is a counter-based hash of (seed, global row, global column,
//   global head), so the backward replays the forward's mask without
//   storing it and the mask does not depend on the tile size. The hash's
//   integer ops issue at half the FP32 rate and dominate the dropout cost,
//   so its first xor-shift is split into a row half and a column half
//   (drop_half), each computed once a row or column and staged with the
//   tile, and only the tail (drop_tail) runs once an element: the same bits
//   as drop_bits. A template argument (DROP) keeps the hash out of the
//   dropout-free instantiation. The seed is one 32-bit word in device
//   memory, drawn there by the run's generator and read once a block, so
//   a step replayed as a CUDA graph draws a new mask every replay.
// - The TPU grid ran in order and carried m/l/acc and the resident dld
//   window across steps. Here blocks run in parallel, one per (row or
//   column block, head): a loop walks the block's occupied tiles with the
//   running sums in registers. In the fused backward dld, a sum across
//   column blocks, is reduced over the warp's columns in registers and
//   shuffles, then across warps in shared memory, and added with one global
//   atomicAdd a row and tile into a zeroed buffer (the order varies from run
//   to run). The column sweep (FUSE_DLD = false) has no atomic: dls and dv
//   are per-thread partials summed in a fixed order, so with the row sweep
//   the split backward is bitwise reproducible (the path
//   torch.use_deterministic_algorithms(True) takes).
// - The row sweep owns whole rows, so dld needs no merge across warps:
//   each thread sums its columns of its two rows over the walk, in walk
//   order, then two quad shuffles finish each row and one store writes it.
//   With the column sweep (no atomics either) the split backward is
//   bitwise reproducible.
// - D is a template argument (4, 8, 16 or 32; the wide bodies 64, and the
//   forward's also 128; ops/flash_gat.py pads any smaller D with zero
//   columns). D = 4 pads the products' n8 or k8 side with zeros, D = 16 and
//   32 take two and four.
// - A wider head takes the wide bodies on 128 x 128 tiles, both still the
//   templates fwd_kernel and bwd_col_kernel<..., true, ...> at D = 64 (and
//   128, the forward): one block per (row or column block, head or chunk)
//   sweeps each tile once for all the chunk's columns, the forward in
//   chunks of 128 (one at D <= 128, two at D = 256), the fused backward in
//   chunks of 64. The narrow route swept a tile once per 32 columns, so the
//   tile's staging and every exp, mask and leaky ReLU of it ran
//   ceil(D / 32) times, and each warp reloaded and split the whole v (or g)
//   tile for its own mma.sync products. What bounds the wide bodies on the
//   H100: the products (3 TF32 products a term; 12,300 cycles of an SM's
//   tensor cores for a 128 x 128 tile's P.V at D = 256), the shared-memory
//   traffic of staging v and g (landed by cp.async, split into TF32 hi and
//   lo and, where the product wants it, transposed: TF32 wgmma reads its B
//   operand K-major only; each warpgroup's products read it again), and
//   the registers (a thread holds 64 rows x D / 128 threads accumulator
//   floats a term). What the design does: two warpgroups of 64 rows
//   (columns) take the products on wgmma with A in the registers where the
//   elementwise work forms it (P; the backward's c' and its block-fixed v)
//   and B staged once for both warpgroups in windows of 16 columns (rows),
//   three windows' buffers, four landing ahead, so that the copies and the
//   split run while the products do; the forward takes the rows' max over
//   the whole walk first (the largest ls over each row's edges, z being
//   monotone in ls), so nothing rescales its accumulators and only the
//   products write them; both take two windows a turn, the second's
//   products queued behind the first's, and wait for both at the turn's
//   end: a product in flight across the loop's back edge, or an
//   accumulator written by other instructions in the sweep, made the
//   compiler copy accumulators and serialize the products. The hi.hi
//   terms accumulate apart from the hi.lo and lo.hi ones; two accumulators
//   of 64 x D fit a thread's registers up to D = 128 (the forward) and,
//   beside v's 64 registers as A, D = 64 (the backward), which sets the
//   chunks: at D = 256 the backward's staging, exps, masks and dz still run
//   four times a tile, and its dld and dls are still per-chunk partials. A
//   block of one warpgroup over 64 columns and 128 of D, v in shared memory
//   as A (64 KiB, hi and lo) and dv's two 64 x 128 accumulators (128
//   registers), would run them twice; not built. The backward's gv takes
//   the window's g K-major as it lies, its dv the window transposed, with
//   the k index permuted (k = t (t + 4) of step s is row 8 s + 2 t (+1)) so
//   that gv's accumulator is dv's A, and a thread's two columns adjacent
//   (one 16-bit adjacency load a row); dld goes out as one atomicAdd a row
//   and window.
// - Every other wide sweep runs as nc chunks of D = 32 columns (ops/
//   flash_gat.py:head_plan zero-pads each head to nc * D), chunk c of head h
//   on block row blockIdx.y = h * nc + c: the split backward (row and
//   column sweeps) at any head wider than 32, and every kernel on tiles
//   other than 128 x 128. The softmax does not depend on v, so each
//   chunk's forward is the D-wide kernel on its columns of v, and lse, the
//   same for every chunk, is written by chunk 0. dz is linear in g.v and
//   delta, so with delta split over the chunks (the head's g.out, formed in
//   torch, in chunk 0 and zeros in the others: [nc][k][n]) each chunk's
//   backward is the D-wide kernel on (v[c], g[c], delta_c): it
//   writes its own columns of dv and its own partial dld and dls
//   ([nc][k][n], summed over the chunks in torch in a fixed order). The
//   dropout keys are (seed, row, column, head), not the chunk, so every
//   chunk replays one mask. v, g, out and dv are rows of k * nc * D
//   elements, head h's chunk c at column (h * nc + c) * D: the layout of
//   k * nc heads of D, which is how the tile bodies address them. At
//   nc = 1 this is the kernel on the whole head.
// - HAN's meta-path towers sweep P graphs of one geometry (han_tpu runs them
//   as one nn.vmap, whose pallas_call gains a leading grid axis): every
//   kernel takes the path on blockIdx.z, so P graphs go in one launch. A
//   block shifts each array by its path's stride (Batch) and reads its
//   path's seed (and, for the strips of a stacked partition, its row-block
//   offset) from device memory; everything else is the single-path kernel,
//   so path p of a batched launch computes what a launch of path p alone
//   computes, bit for bit. Paths padded to the largest tile list and map
//   width cost nothing: the counts bound each block's walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B9u;

struct Drop {
  int on;
  const uint32_t* seed;  // one word in device memory, read once a block
  uint32_t thresh;  // keep iff bits < thresh = floor((1 - p) * 2^32)
  float scale;      // 1 / (1 - p)
};

struct Offsets {
  int row_block;
  int head;
  int col_block;
};

// A batched launch sweeps P graphs of one geometry (HAN's meta-paths, the
// counterpart of a vmapped pallas_call): path p = blockIdx.z. Every array
// holds the P paths back to back, each at the single-path layout: tiles
// [P, t_pitch, bm, bn], maps [P, nb, pitch], counts [P, nb], the (k, n)
// vectors [P, k, n], the (n, k*d) features [P, n, k*d], and the seeds
// [P] (one word a path). P = 1 is the single-path call.
struct Batch {
  int t_pitch;           // tile slots a path
  const int* row_block;  // [P] row-block offsets added to Offsets::row_block, or null
};

// Path p's dropout seed and global row-block offset.
struct PathKeys {
  uint32_t seed;
  int row_block;
};

template <bool DROP>
__device__ __forceinline__ PathKeys path_keys(const Drop& drop, const Offsets& off,
                                              const Batch& batch, int p) {
  return {DROP ? drop.seed[p] : 0u, off.row_block + (batch.row_block ? batch.row_block[p] : 0)};
}

// murmur3 finalizer (drop_half, drop_tail: csrc/tile_mma.cuh);
// ops/flash_gat.py:fmix32 is the same function on int64
__device__ __forceinline__ uint32_t fmix32(uint32_t h) { return drop_tail(drop_half(h)); }

__device__ __forceinline__ uint32_t drop_head_key(uint32_t seed, uint32_t head) {
  return fmix32(seed ^ fmix32(head + GOLDEN));
}

__device__ __forceinline__ uint32_t drop_row_key(uint32_t head_key, uint32_t row) {
  return fmix32(head_key ^ row);
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t row_key, uint32_t col) {
  return fmix32(row_key ^ (col * GOLDEN));
}

// ---------------------------------------------------------------------------
// asynchronous staging: cp.async into a two-stage ring, one commit group a
// tile
// ---------------------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src),
                 "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// A thread's share of the 16-byte chunks of a bm x bn adjacency tile, the
// chunks tid, tid + nthr, ..., as (row, chunk) pairs; the divisions are
// done once per kernel. The tile is staged in parts of one chunk a thread
// (AdjCursor::copy), issued between the computation's shared-memory loads
// rather than queued ahead of them.
struct AdjSweep {
  int per_row, r0, q0, dr, dq;
  __device__ AdjSweep(int bn, int tid, int nthr)
      : per_row(bn / 16), r0(tid / per_row), q0(tid % per_row),
        dr(nthr / per_row), dq(nthr % per_row) {}
};

struct AdjCursor {
  unsigned char* dst;
  const unsigned char* src;
  int bn, r, q;
  __device__ AdjCursor(unsigned char* dst_, const int8_t* tiles, int t, int bm, int bn_,
                       const AdjSweep& sw)
      : dst(dst_),
        src(reinterpret_cast<const unsigned char*>(tiles) + (size_t)t * bm * bn_),
        bn(bn_), r(sw.r0), q(sw.q0) {}
  // the next of this thread's chunks, into rows of pitch bn + APAD
  __device__ __forceinline__ void copy(const AdjSweep& sw) {
    cp_async<16>(dst + r * (bn + APAD) + 16 * q, src + (size_t)r * bn + 16 * q);
    q += sw.dq;
    r += sw.dr;
    if (q >= sw.per_row) {
      q -= sw.per_row;
      ++r;
    }
  }
};

// n floats (n % 4 == 0, 16-byte aligned) from global to shared
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n,
                                             int tid, int nthr) {
  for (int i = tid; i < n / 4; i += nthr) cp_async<16>(dst + 4 * i, src + 4 * i);
}

// ---------------------------------------------------------------------------
// forward: block (row block rb, head h), bm / 16 warps; warp w owns rows
// 16 w .. 16 w + 15 of the block, thread (g, t) rows 16 w + g and
// 16 w + g + 8 as the m16 side of P.V. In a 16-column window the k index t
// (t + 4) of k step hh is column 4 t + 2 hh (+1), so a thread's four
// columns are one adjacency word.
// ---------------------------------------------------------------------------

__host__ __device__ inline int fwd_stage_bytes(int bm, int bn, int d, int vbytes) {
  return bm * (bn + APAD) + 2 * bn * 4 + bn * d * vbytes;  // adjacency, ls, column keys, v
}

template <int D, typename VT, bool DROP>
__device__ __forceinline__ void fwd_narrow(
    const int8_t* __restrict__ tiles, const int* __restrict__ fcount,
    const int* __restrict__ fcol, const int* __restrict__ ftile, int c_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int n_rows, int n_cols, int bm, int bn, int k,
    int nc, float slope, Drop drop, Offsets off, Batch batch) {
  constexpr int ND = (D + 7) / 8;              // n8 tiles of the head dim
  constexpr int VCOL = D * (int)sizeof(VT);    // bytes of one column of v
  constexpr int VCH = VCOL < 16 ? VCOL : 16;   // cp.async size for v
  extern __shared__ __align__(16) unsigned char smem[];
  const int apitch = bn + APAD;
  const int stage_bytes = fwd_stage_bytes(bm, bn, D, sizeof(VT));

  // head h's chunk hc - h * nc: its columns of v and out start at hc * D
  const int rb = blockIdx.x, hc = blockIdx.y, h = hc / nc;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r_lo = (tid >> 5) * 16 + gq;  // rows r_lo and r_lo + 8
  const int kd = k * nc * D;

  // this block's path of a batched launch (Batch)
  const size_t pr = (size_t)blockIdx.z * n_rows, pc = (size_t)blockIdx.z * n_cols;
  tiles += (size_t)blockIdx.z * batch.t_pitch * bm * bn;
  fcount += pr / bm;
  fcol += pr / bm * c_pitch;
  ftile += pr / bm * c_pitch;
  ld += pr * k;
  ls += pc * k;
  v += pc * kd;
  out += pr * kd;
  lse += pr * k;
  const PathKeys pk = path_keys<DROP>(drop, off, batch, blockIdx.z);

  const uint32_t head_key = DROP ? drop_head_key(pk.seed, off.head + h) : 0u;
  float ld2[2], m[2], l[2];
  uint32_t row_key[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r_lo + 8 * rr;
    ld2[rr] = ld[(size_t)h * n_rows + (size_t)rb * bm + r] * LOG2E;
    row_key[rr] = DROP ? drop_half(drop_row_key(head_key,
                                                (uint32_t)((pk.row_block + rb) * bm + r)))
                       : 0u;
    m[rr] = NEG2;
    l[rr] = 0.f;
  }
  float acc[3][ND][4];  // the hi.hi, hi.lo and lo.hi terms of P.V
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][nt][e] = 0.f;

  const int count = fcount[rb];
  const int* step_col = fcol + (size_t)rb * c_pitch;
  const int* step_tile = ftile + (size_t)rb * c_pitch;
  const AdjSweep sweep(bn, tid, nthr);

  // the ls and v slices of step s; its adjacency goes through an AdjCursor
  auto stage_slices = [&](int s, int cb) {
    unsigned char* buf = smem + (s & 1) * stage_bytes;
    float* ls_s = reinterpret_cast<float*>(buf + bm * apitch);
    stage_floats(ls_s, ls + (size_t)h * n_cols + (size_t)cb * bn, bn, tid, nthr);
    if constexpr (DROP) {  // the column halves of the dropout hash
      uint32_t* ck_s = reinterpret_cast<uint32_t*>(ls_s + bn);
      for (int c = tid; c < bn; c += nthr)
        ck_s[c] = drop_half((uint32_t)((off.col_block + cb) * bn + c) * GOLDEN);
    }
    unsigned char* v_s = reinterpret_cast<unsigned char*>(ls_s + 2 * bn);
    constexpr int VQ = VCOL / VCH;
    for (int i = tid; i < bn * VQ; i += nthr) {
      const int c = i / VQ, q = i - c * VQ;
      cp_async<VCH>(v_s + vslot(c) * VCOL + q * VCH,
                    reinterpret_cast<const unsigned char*>(
                        v + ((size_t)cb * bn + c) * kd + hc * D) + q * VCH);
    }
  };

  // the map entries of steps s (cur), s + 1 (next) and s + 2 (loaded a
  // step ahead, so that no stage waits on a global load)
  int cb_cur = count > 0 ? step_col[0] : 0;
  int cb_next = count > 1 ? step_col[1] : 0, t_next = count > 1 ? step_tile[1] : 0;
  if (count > 0) {
    stage_slices(0, cb_cur);
    AdjCursor first(smem, tiles, step_tile[0], bm, bn, sweep);
    for (int j = 0; j < bn / 32; ++j) first.copy(sweep);
    cp_async_commit();
  }
  for (int s = 0; s < count; ++s) {
    const int cb_after = s + 2 < count ? step_col[s + 2] : 0;
    const int t_after = s + 2 < count ? step_tile[s + 2] : 0;
    cp_async_wait_all();
    __syncthreads();  // tile s is visible; every warp is done with tile s - 1
    // tile s + 1 lands while tile s computes: its slices now, its adjacency
    // a part (bn / 32 of them, one chunk a thread) per 32-column chunk
    const bool more = s + 1 < count;
    if (more) stage_slices(s + 1, cb_next);
    AdjCursor next(smem + ((s + 1) & 1) * stage_bytes, tiles, t_next, bm, bn, sweep);
    const unsigned char* adj_s = smem + (s & 1) * stage_bytes;
    const float* ls_s = reinterpret_cast<const float*>(adj_s + bm * apitch);
    const uint32_t* ck_s = reinterpret_cast<const uint32_t*>(ls_s + bn);
    const VT* v_s = reinterpret_cast<const VT*>(ls_s + 2 * bn);
    cb_cur = cb_next;
    cb_next = cb_after;
    t_next = t_after;
    // this thread's v columns of a 16-column window at k step hh, after the
    // swizzle: vslot(base + r) = base + vslot(r) for base a multiple of 16
    const int vo[2][2] = {{vslot(4 * tq) * D, vslot(4 * tq + 1) * D},
                          {vslot(4 * tq + 2) * D, vslot(4 * tq + 3) * D}};

#pragma unroll 2
    for (int c0 = 0; c0 < bn; c0 += 32)
      fwd_chunk<D, VT, DROP, true>(adj_s, apitch, ls_s, ck_s, v_s, vo, c0, r_lo, gq, tq, ld2,
                                   slope, row_key, drop.thresh, m, l, acc, [&] {
                                     if (more) next.copy(sweep);
                                   });
    cp_async_commit();
  }

  // finalize: l over the quad; acc is complete (the products summed the
  // quad's columns)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr] + __shfl_xor_sync(FULL_MASK, l[rr], 1);
    lt += __shfl_xor_sync(FULL_MASK, lt, 2);
    const bool has_edge = m[rr] > 0.5f * NEG2;
    const float lsum = fmaxf(lt, 1e-30f);
    const float inv = has_edge ? (DROP ? drop.scale : 1.f) / lsum : 0.f;
    const size_t row = (size_t)rb * bm + r_lo + 8 * rr;
    float* o = out + row * kd + hc * D;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
      const int d = 8 * nt + 2 * tq;
      const int e = 2 * rr;
      if (D >= 8 || d < D)
        *reinterpret_cast<float2*>(o + d) = make_float2(
            (acc[1][nt][e] + acc[2][nt][e] + acc[0][nt][e]) * inv,
            (acc[1][nt][e + 1] + acc[2][nt][e + 1] + acc[0][nt][e + 1]) * inv);
    }
    if (tq == 0 && hc == h * nc)  // chunk 0: lse is every chunk's
      lse[(size_t)h * n_rows + row] = has_edge ? (m[rr] + log2f(lsum)) * LN2 : NEG_INIT;
  }
}

// ---------------------------------------------------------------------------
// the wide forward (D = 64 or 128): block (row block rb, head h or half a
// head) over the chunk's whole width, 128 x 128 tiles, two warpgroups of 64
// rows; thread (g, t) of warp w holds rows r_lo = 16 w + g and r_lo + 8 as
// above. A tile sweeps as 8 windows of 16 columns, each two k8 steps of P.V
// on wgmma: P, formed once a tile and head in the A-fragment registers (k
// index t (t + 4) of step s is column 4 t + 2 s (+1) of the window, so that
// a thread's four columns are one adjacency word), against the window's v
// staged once in shared memory for both warpgroups as the K-major B
// operand (wide_off), TF32 hi and lo planes. The rows' max over the whole
// walk is taken before it (the largest ls over a row's edges: z is
// monotone in ls), so no sum is rescaled.
// ---------------------------------------------------------------------------

constexpr int WIN = 16;      // columns of a window
constexpr int WIDE_BM = 128;  // rows (and columns) of a tile the wide body takes
constexpr int WIDE_THREADS = 256;
constexpr int RAW_AHEAD = 3;  // windows of v in flight ahead of the one split next
constexpr int NSPLIT = 3;     // split windows: two read by products in flight, one being split

// floats of one plane of a split window: two k8 steps of D x 8 values
template <int D>
__host__ __device__ constexpr int wide_plane() {
  return 2 * 8 * D;
}

// The float offset of (k step s, head-dim index d, k index kk) in a plane:
// core matrix (d / 8, kk / 4) of 32 floats at (2 (d / 8) + kk / 4) * 32, row
// d % 8 at 4 (d % 8), value kk % 4; wgmma's lbo 128 bytes, sbo 256. A
// quarter-warp's 16-byte splitting stores (lane: d % 8) hit 8 bank quads.
template <int D>
__device__ __forceinline__ int wide_off(int s, int d, int kk) {
  return s * 8 * D + (d >> 3) * 64 + (kk >> 2) * 32 + (d & 7) * 4 + (kk & 3);
}

// bytes of a split window: its hi plane, and its lo plane for f32 v
template <int D, typename VT>
__host__ __device__ constexpr int wide_win_bytes() {
  return (std::is_same<VT, float>::value ? 2 : 1) * wide_plane<D>() * 4;
}

// bytes of a window of v as it lands (16-byte cp.async copies): 16 columns
// of D + 8 values, so that the splitting loads hit 32 banks
template <int D, typename VT>
__host__ __device__ constexpr int wide_raw_bytes() {
  return WIN * (D + 8) * (int)sizeof(VT);
}

template <int D, typename VT>
__host__ __device__ constexpr int wide_smem_bytes() {
  return NSPLIT * wide_win_bytes<D, VT>() + (RAW_AHEAD + 1) * wide_raw_bytes<D, VT>() +
         2 * (WIDE_BM * (WIDE_BM + APAD) + 2 * WIDE_BM * 4);  // + 2 tiles: adjacency, ls, keys
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int D, typename VT, bool DROP>
__device__ __forceinline__ void fwd_wide(
    const int8_t* __restrict__ tiles, const int* __restrict__ fcount,
    const int* __restrict__ fcol, const int* __restrict__ ftile, int c_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int n_rows, int n_cols, int k, int nc, float slope, Drop drop,
    Offsets off, Batch batch) {
  constexpr int bm = WIDE_BM, bn = WIDE_BM, apitch = bn + APAD, NWIN = bn / WIN;
  constexpr int TILE_BYTES = bm * apitch + 2 * bn * 4;
  constexpr bool V_EXACT = std::is_same<VT, __nv_bfloat16>::value;  // no lo plane
  constexpr int PL = wide_plane<D>();
  static_assert(D == 64 || D == 128, "the wide body's widths (wider heads run in chunks)");
  constexpr int NW = D / 2;  // accumulator floats of a product (64 rows x D)
  constexpr int NG = D / 64;             // column quads a thread splits a window
  constexpr int RP = D + 8;              // values a landed column of v takes
  constexpr int VCH = 16 / (int)sizeof(VT);  // values a copy
  constexpr int NR = RAW_AHEAD + 1;      // landed windows
  static_assert((NR & (NR - 1)) == 0, "a power of two of landed windows");
  extern __shared__ __align__(16) unsigned char smem_w[];
  float* win_s = reinterpret_cast<float*>(smem_w);  // NSPLIT split windows
  VT* raw_s = reinterpret_cast<VT*>(smem_w + NSPLIT * wide_win_bytes<D, VT>());  // NR landed
  unsigned char* tile_s =
      smem_w + NSPLIT * wide_win_bytes<D, VT>() + NR * wide_raw_bytes<D, VT>();

  // head h's chunk hc - h * nc: its columns of v and out start at hc * D
  const int rb = blockIdx.x, hc = blockIdx.y, h = hc / nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3, wi = tid >> 5;
  const int r_lo = wi * 16 + gq;  // rows r_lo and r_lo + 8
  const int kd = k * nc * D;

  // this block's path of a batched launch (Batch)
  const size_t pr = (size_t)blockIdx.z * n_rows, pc = (size_t)blockIdx.z * n_cols;
  tiles += (size_t)blockIdx.z * batch.t_pitch * bm * bn;
  fcount += pr / bm;
  fcol += pr / bm * c_pitch;
  ftile += pr / bm * c_pitch;
  ld += pr * k;
  ls += pc * k;
  v += pc * kd;
  out += pr * kd;
  lse += pr * k;
  const PathKeys pk = path_keys<DROP>(drop, off, batch, blockIdx.z);

  const uint32_t head_key = DROP ? drop_head_key(pk.seed, off.head + h) : 0u;
  float ld2[2], m[2], l[2];
  uint32_t row_key[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r_lo + 8 * rr;
    ld2[rr] = ld[(size_t)h * n_rows + (size_t)rb * bm + r] * LOG2E;
    row_key[rr] = DROP ? drop_half(drop_row_key(head_key,
                                                (uint32_t)((pk.row_block + rb) * bm + r)))
                       : 0u;
    m[rr] = NEG2;
    l[rr] = 0.f;
  }
  // the hi.hi terms of P.V apart from the small ones (hi.lo + lo.hi)
  float acc_hh[NW], acc_sm[NW];
#pragma unroll
  for (int e = 0; e < NW; ++e) acc_hh[e] = acc_sm[e] = 0.f;

  // the walk's length, warp-uniform as the compiler sees it (a shuffle):
  // the products' pipeline stays in one path
  const int count = __shfl_sync(FULL_MASK, fcount[rb], 0);
  const int* step_col = fcol + (size_t)rb * c_pitch;
  const int* step_tile = ftile + (size_t)rb * c_pitch;
  const int total = count * NWIN;

  // Window wq of the walk lands by cp.async (the columns RP values apart)
  // in landed buffer wq % NR, with, at a tile's first window, the tile's
  // adjacency, ls and column keys in tile buffer s % 2: one commit group a
  // window, empty past the walk's end.
  auto land = [&](int wq) {
    if (wq < total) {
      const int s = wq / NWIN, w = wq - s * NWIN;
      const int cb = step_col[s];
      VT* dst = raw_s + (wq & (NR - 1)) * (wide_raw_bytes<D, VT>() / (int)sizeof(VT));
      const VT* src = v + ((size_t)cb * bn + w * WIN) * kd + hc * D;
      constexpr int CPR = D / VCH;  // copies a column
#pragma unroll
      for (int j = 0; j < (WIN * CPR + WIDE_THREADS - 1) / WIDE_THREADS; ++j) {
        const int i = tid + j * WIDE_THREADS, r = i / CPR, q = i - r * CPR;
        if (WIN * CPR % WIDE_THREADS == 0 || i < WIN * CPR)
          cp_async<16>(dst + r * RP + VCH * q, src + (size_t)r * kd + VCH * q);
      }
      if (w == 0) {
        unsigned char* buf = tile_s + (s & 1) * TILE_BYTES;
        const unsigned char* adj =
            reinterpret_cast<const unsigned char*>(tiles) + (size_t)step_tile[s] * bm * bn;
#pragma unroll
        for (int j = 0; j < bm * bn / 16 / WIDE_THREADS; ++j) {
          const int i = tid + j * WIDE_THREADS, r = i / (bn / 16), q = i - r * (bn / 16);
          cp_async<16>(buf + r * apitch + 16 * q, adj + r * bn + 16 * q);
        }
        float* ls_s = reinterpret_cast<float*>(buf + bm * apitch);
        stage_floats(ls_s, ls + (size_t)h * n_cols + (size_t)cb * bn, bn, tid, WIDE_THREADS);
        if constexpr (DROP) {  // the column halves of the dropout hash
          uint32_t* ck_s = reinterpret_cast<uint32_t*>(ls_s + bn);
          for (int c = tid; c < bn; c += WIDE_THREADS)
            ck_s[c] = drop_half((uint32_t)((off.col_block + cb) * bn + c) * GOLDEN);
        }
      }
    }
    cp_async_commit();
  };
  // Landed window wq split into TF32 hi and lo (split_tf32) in split buffer
  // wq % 2, once for both warpgroups: this thread's values are the column
  // quad c + 4 t (t < 4, c = lane >> 3), which is k index 4 (c & 1) + t of
  // step c >> 1, at head-dim indices 8 q + (lane & 7) for the octets q = w,
  // w + 8, ...: four loads and one 16-byte store a plane; the loads of the
  // 32 lanes hit 32 banks, the stores of each quarter-warp 8 bank quads.
  auto split = [&](int wq) {
    const int c = lane >> 3;
    const VT* src = raw_s + (wq & (NR - 1)) * (wide_raw_bytes<D, VT>() / (int)sizeof(VT)) +
                    c * RP + (lane & 7);
    float* dst = win_s + (wq % NSPLIT) * (wide_win_bytes<D, VT>() / 4);
    float x[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) x[j][t] = to_f32(src[4 * t * RP + 8 * (wi + 8 * j)]);
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      float4* o = reinterpret_cast<float4*>(
          dst + wide_off<D>(c >> 1, 8 * (wi + 8 * j) + (lane & 7), 4 * (c & 1)));
      if constexpr (V_EXACT) {
        *o = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);  // bf16 is TF32 already
      } else {
        const Tf32x2 y[4] = {split_tf32(x[j][0]), split_tf32(x[j][1]), split_tf32(x[j][2]),
                             split_tf32(x[j][3])};
        *o = make_float4(__uint_as_float(y[0].hi), __uint_as_float(y[1].hi),
                         __uint_as_float(y[2].hi), __uint_as_float(y[3].hi));
        o[PL / 4] = make_float4(__uint_as_float(y[0].lo), __uint_as_float(y[1].lo),
                                __uint_as_float(y[2].lo), __uint_as_float(y[3].lo));
      }
    }
    fence_async_smem();
  };

  if (total > 0) {
#pragma unroll
    for (int j = 0; j <= RAW_AHEAD; ++j) land(j);
    // the rows' max over the whole walk before it, from the tiles and ls in
    // global memory while the first windows land: the largest ls over a
    // row's edges (z is monotone in ls), over the quad. With it no sum is
    // ever rescaled, and nothing but the products writes acc in the sweep.
    float mx[2] = {-INFINITY, -INFINITY};
    for (int s0 = 0; s0 < count; s0 += 2) {  // two tiles' loads in flight
      float4 l4[2][NWIN];
      uint32_t bits[2][NWIN][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = s0 + u < count ? s0 + u : s0;
        const unsigned char* adj =
            reinterpret_cast<const unsigned char*>(tiles) + (size_t)step_tile[s] * bm * bn;
        const float* lsg = ls + (size_t)h * n_cols + (size_t)step_col[s] * bn;
#pragma unroll
        for (int w = 0; w < NWIN; ++w) {
          const int c = WIN * w + 4 * tq;
          l4[u][w] = __ldg(reinterpret_cast<const float4*>(lsg + c));
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            bits[u][w][rr] =
                __ldg(reinterpret_cast<const unsigned*>(adj + (r_lo + 8 * rr) * bn + c));
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int w = 0; w < NWIN; ++w) {
          const float lsv[4] = {l4[u][w].x, l4[u][w].y, l4[u][w].z, l4[u][w].w};
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              mx[rr] = (bits[u][w][rr] & (0xffu << (8 * b))) ? fmaxf(mx[rr], lsv[b]) : mx[rr];
        }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = fmaxf(mx[rr], __shfl_xor_sync(FULL_MASK, mx[rr], 1));
      x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 2));
      const float raw = fmaf(x, LOG2E, ld2[rr]);
      m[rr] = x == -INFINITY ? NEG2 : fmaxf(raw, slope * raw);
    }
  }

  // p of window wq's columns WIN w + 4 t + b: undropped into l, dropped into
  // the product (reference order); 0 off the edges of a row with an edge (a
  // row without one sums junk that the finalize discards)
  float p[2][4];
  auto probs = [&](int wq) {
    const unsigned char* adj_s = tile_s + ((wq / NWIN) & 1) * TILE_BYTES;
    const float* ls_s = reinterpret_cast<const float*>(adj_s + bm * apitch);
    const int c = WIN * (wq % NWIN) + 4 * tq;
    const float4 l4 = *reinterpret_cast<const float4*>(ls_s + c);
    const float lsv[4] = {l4.x, l4.y, l4.z, l4.w};
    uint32_t key[4] = {0u, 0u, 0u, 0u};
    if constexpr (DROP) {
      const uint4 k4 = *reinterpret_cast<const uint4*>(ls_s + bn + c);
      key[0] = k4.x;
      key[1] = k4.y;
      key[2] = k4.z;
      key[3] = k4.w;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const uint32_t bits =
          *reinterpret_cast<const uint32_t*>(adj_s + (r_lo + 8 * rr) * apitch + c);
      float pu[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float raw = fmaf(lsv[b], LOG2E, ld2[rr]);
        const float zz = fmaxf(raw, slope * raw);
        pu[b] = ex2(((bits & (0xffu << (8 * b))) ? zz : NEG2) - m[rr]);
        p[rr][b] = pu[b];
        if constexpr (DROP) p[rr][b] = drop_tail(row_key[rr] ^ key[b]) < drop.thresh ? pu[b] : 0.f;
      }
      l[rr] += (pu[0] + pu[1]) + (pu[2] + pu[3]);
    }
  };

  if (total > 0) {
    cp_async_wait<RAW_AHEAD - 1>();  // windows 0 and 1, tile 0
    __syncthreads();
    split(0);
    probs(0);
  }
  // Window wq: its products started (behind window wq - 1's in a pair), then,
  // while they run, window wq + 1 split and its p formed and window wq + 1 +
  // RAW_AHEAD sent on its way. A turn of the loop takes two windows and
  // waits for their products at its end, so that the tensor cores hold a
  // queued window across the pair's middle, and no product is in flight
  // across the loop's back edge (where the compiler would move
  // accumulators).
  uint32_t ahi[2][2][4], alo[2][2][4];  // the A registers of a pair's windows
  auto step = [&](int wq, auto par) {
    constexpr int P = decltype(par)::value;
    // window wq is split; every warpgroup is done with the products that
    // read the split window and A registers this step reuses
    __syncthreads();
    // acc += P.V over the window's two k steps: lo.hi, hi.lo, then hi.hi;
    // every register the products read is set before the fence
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const Tf32x2 a = split_tf32(p[x & 1][2 * ks + (x >> 1)]);
        ahi[P][ks][x] = a.hi;
        alo[P][ks][x] = a.lo;
      }
    const uint64_t desc =
        wg_desc(win_s + (wq % NSPLIT) * (wide_win_bytes<D, VT>() / 4), 128, 256);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // the descriptor's address field counts 16 bytes
      const uint64_t bhi = desc + (uint64_t)(ks * 8 * D / 4);
      wgmma_tf32(acc_sm, alo[P][ks], bhi);
      if constexpr (!V_EXACT) wgmma_tf32(acc_sm, ahi[P][ks], bhi + PL / 4);
      wgmma_tf32(acc_hh, ahi[P][ks], bhi);
    }
    wg_commit();
    if (wq + 1 < total) {
      split(wq + 1);
      probs(wq + 1);
    }
    land(wq + 1 + RAW_AHEAD);        // into window wq's landed buffer
    cp_async_wait<RAW_AHEAD - 1>();  // window wq + 2 (and its tile) has landed
  };
  for (int wq = 0; wq < total; wq += 2) {
    step(wq, std::integral_constant<int, 0>{});
    if (wq + 1 < total) step(wq + 1, std::integral_constant<int, 1>{});
    wg_wait<0>();
    wg_pin(acc_hh);
    wg_pin(acc_sm);
  }

  // finalize: l over the quad; acc is complete (the products summed the
  // quad's columns)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr] + __shfl_xor_sync(FULL_MASK, l[rr], 1);
    lt += __shfl_xor_sync(FULL_MASK, lt, 2);
    const bool has_edge = m[rr] > 0.5f * NEG2;
    const float lsum = fmaxf(lt, 1e-30f);
    const float inv = has_edge ? (DROP ? drop.scale : 1.f) / lsum : 0.f;
    const size_t row = (size_t)rb * bm + r_lo + 8 * rr;
    float* o = out + row * kd + hc * D;
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const int e = 4 * i + 2 * rr;
      *reinterpret_cast<float2*>(o + 8 * i + 2 * tq) =
          make_float2((acc_sm[e] + acc_hh[e]) * inv, (acc_sm[e + 1] + acc_hh[e + 1]) * inv);
    }
    if (tq == 0 && hc == h * nc)  // chunk 0: lse is every chunk's
      lse[(size_t)h * n_rows + row] = has_edge ? (m[rr] + log2f(lsum)) * LN2 : NEG_INIT;
  }
}

// The forward: the wide body at D >= 64 (128 x 128 tiles), else the narrow one.
template <int D, typename VT, bool DROP>
__global__ void __launch_bounds__(D >= 64 ? WIDE_THREADS : 512) fwd_kernel(
    const int8_t* __restrict__ tiles, const int* __restrict__ fcount,
    const int* __restrict__ fcol, const int* __restrict__ ftile, int c_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int n_rows, int n_cols, int bm, int bn, int k,
    int nc, float slope, Drop drop, Offsets off, Batch batch) {
  if constexpr (D >= 64)
    fwd_wide<D, VT, DROP>(tiles, fcount, fcol, ftile, c_pitch, ld, ls, v, out, lse, n_rows,
                          n_cols, k, nc, slope, drop, off, batch);
  else
    fwd_narrow<D, VT, DROP>(tiles, fcount, fcol, ftile, c_pitch, ld, ls, v, out, lse, n_rows,
                            n_cols, bm, bn, k, nc, slope, drop, off, batch);
}

// ---------------------------------------------------------------------------
// backward column sweep: block (column block cb, head h), 2 bn / 32 warps.
// Warp (cq, rh) owns columns 32 cq .. 32 cq + 31 and the rh-th half of each
// tile's rows; thread (g, t) columns j0 = 32 cq + 4 g .. j0 + 3, which are
// the m side (m16 tiles 0 and 1: rows g and g + 8 are columns j0 + 2 tile
// and j0 + 2 tile + 1) of gv = V.G^T and of dv += C'.G. In a patch of 8
// rows, C's n index 2 t (2 t + 1) is row i0 + 2 t (+1), and dv's k index
// t (t + 4) the same row, so the g.v accumulator is the A operand of dv.
// Writes dls and dv once per column. FUSE_DLD (the fused backward) also
// sums dld: over the warp's columns by shuffles, over the column warps in
// shared memory, then one atomicAdd a row and tile into the zeroed global
// buffer. Without it (the split backward's column sweep) the kernel has no
// atomic at all.
// ---------------------------------------------------------------------------

__host__ __device__ inline int bwd_stage_bytes(int bm, int bn, int d) {
  // adjacency; ld, lse, delta, row keys; g (rows padded to gpitch floats:
  // the B-fragment loads hit distinct banks)
  return bm * (bn + APAD) + 4 * bm * 4 + bm * gpitch(d) * 4;
}

template <int D, bool FUSE_DLD, typename VT, bool DROP>
__device__ __forceinline__ void bwd_narrow(
    const int8_t* __restrict__ tiles, const int* __restrict__ bcount,
    const int* __restrict__ brow, const int* __restrict__ btile, int r_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dld, float* __restrict__ dls, float* __restrict__ dv,
    int n_rows, int n_cols, int bm, int bn, int k, int nc, float slope, Drop drop,
    Offsets off, Batch batch) {
  constexpr int KD = (D + 7) / 8;  // k8 steps (g.v) and n8 tiles (dv) of D
  constexpr int GP = gpitch(D);
  extern __shared__ __align__(16) unsigned char smem[];
  const int apitch = bn + APAD;
  const int stage_bytes = bwd_stage_bytes(bm, bn, D);
  const int n_cw = bn / 32;  // column warps
  // [2][n_cw][bm] dld partials (FUSE_DLD), after the stages or the merge
  const int merge_bytes = bn * (D + 1) * 4;
  float* dld_s = reinterpret_cast<float*>(
      smem + (2 * stage_bytes > merge_bytes ? 2 * stage_bytes : merge_bytes));

  // head h's chunk hc - h * nc: its columns of v, g and dv start at hc * D
  const int cb = blockIdx.x, hc = blockIdx.y, h = hc / nc;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int cq = (tid >> 5) % n_cw, rh = (tid >> 5) / n_cw;
  const int half = bm / 2;
  const int j0 = 32 * cq + 4 * gq;
  const int kd = k * nc * D;

  // this block's path of a batched launch (Batch); dld's atomics stay in
  // the path's own rows. delta, dld and dls are [P][nc][k][n]: this
  // block's (path, chunk) slice
  const size_t pr = (size_t)blockIdx.z * n_rows, pc = (size_t)blockIdx.z * n_cols;
  const size_t pq = (size_t)blockIdx.z * nc + (hc - h * nc);
  tiles += (size_t)blockIdx.z * batch.t_pitch * bm * bn;
  bcount += pc / bn;
  brow += pc / bn * r_pitch;
  btile += pc / bn * r_pitch;
  ld += pr * k;
  ls += pc * k;
  v += pc * kd;
  g += pr * kd;
  lse += pr * k;
  delta += pq * k * n_rows;
  if constexpr (FUSE_DLD) dld += pq * k * n_rows;
  dls += pq * k * n_cols;
  dv += pc * kd;
  const PathKeys pk = path_keys<DROP>(drop, off, batch, blockIdx.z);

  // per column: ls, the dropout column key, and v as the A operand of g.v
  // (a0 (column j0 + 2 tile, d = t), a1 (j0 + 2 tile + 1, t), a2 (j0 +
  // 2 tile, t + 4), a3 (j0 + 2 tile + 1, t + 4), d + 8 kk at k step kk)
  float ls_j[4];
  uint32_t col_key[4];
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) {
    ls_j[j4] = ls[(size_t)h * n_cols + (size_t)cb * bn + j0 + j4];
    col_key[j4] = DROP ? drop_half((uint32_t)((off.col_block + cb) * bn + j0 + j4) * GOLDEN) : 0u;
  }
  Tf32x2 va[2][KD][4];
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int idx = 0; idx < 4; ++idx) {
        const int col = j0 + 2 * tile + (idx & 1);
        const int d = 8 * kk + tq + 4 * (idx >> 1);
        va[tile][kk][idx] = split_tf32(
            d < D ? to_f32(v[((size_t)cb * bn + col) * kd + hc * D + d]) : 0.f);
      }
  float dls_j[4] = {0.f, 0.f, 0.f, 0.f};
  float dv_acc[2][KD][4];
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int nt = 0; nt < KD; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[tile][nt][e] = 0.f;

  const uint32_t head_key = DROP ? drop_head_key(pk.seed, off.head + h) : 0u;
  const int count = bcount[cb];
  const int* step_row = brow + (size_t)cb * r_pitch;
  const int* step_tile = btile + (size_t)cb * r_pitch;
  const AdjSweep sweep(bn, tid, nthr);

  // the ld, lse, delta and g slices and the row keys of step s; its
  // adjacency goes through an AdjCursor
  auto stage_slices = [&](int s, int rb) {
    unsigned char* buf = smem + (s & 1) * stage_bytes;
    float* vec_s = reinterpret_cast<float*>(buf + bm * apitch);
    const size_t hr = (size_t)h * n_rows + (size_t)rb * bm;
    stage_floats(vec_s, ld + hr, bm, tid, nthr);
    stage_floats(vec_s + bm, lse + hr, bm, tid, nthr);
    stage_floats(vec_s + 2 * bm, delta + hr, bm, tid, nthr);
    if constexpr (DROP) {  // the row keys, hashed once a row and block
      uint32_t* rk_s = reinterpret_cast<uint32_t*>(vec_s + 3 * bm);
      for (int i = tid; i < bm; i += nthr)
        rk_s[i] = drop_half(drop_row_key(head_key, (uint32_t)((pk.row_block + rb) * bm + i)));
    }
    float* g_s = vec_s + 4 * bm;
    constexpr int GQ = D / 4;  // 16-byte chunks of a row of g
    for (int i = tid; i < bm * GQ; i += nthr) {
      const int r = i / GQ, q = i - r * GQ;
      cp_async<16>(g_s + r * GP + 4 * q, g + ((size_t)rb * bm + r) * kd + hc * D + 4 * q);
    }
  };

  // dld of a finished tile: the column warps' partials summed in shared
  // memory, one global atomicAdd a row
  auto flush_dld = [&](const float* part, int rb) {
    for (int i = tid; i < bm; i += nthr) {
      float x = 0.f;
      for (int q = 0; q < n_cw; ++q) x += part[q * bm + i];
      atomicAdd(&dld[(size_t)h * n_rows + (size_t)rb * bm + i], x);
    }
  };

  // the map entries of steps s - 1 (prev), s + 1 (next) and s + 2 (loaded
  // a step ahead, so that no stage waits on a global load)
  int rb_prev = 0, rb_cur = count > 0 ? step_row[0] : 0;
  int rb_next = count > 1 ? step_row[1] : 0, t_next = count > 1 ? step_tile[1] : 0;
  if (count > 0) {
    stage_slices(0, rb_cur);
    AdjCursor first(smem, tiles, step_tile[0], bm, bn, sweep);
    for (int j = 0; j < bm / 32; ++j) first.copy(sweep);
    cp_async_commit();
  }
  for (int s = 0; s < count; ++s) {
    const int rb_after = s + 2 < count ? step_row[s + 2] : 0;
    const int t_after = s + 2 < count ? step_tile[s + 2] : 0;
    cp_async_wait_all();
    __syncthreads();  // tile s is visible; every warp is done with tile s - 1
    // tile s + 1 lands while tile s computes: its slices now, its adjacency
    // a part (bm / 32 of them, one chunk a thread) per patch of the first
    // bm / 32 patches
    const bool more = s + 1 < count;
    if (more) stage_slices(s + 1, rb_next);
    AdjCursor next(smem + ((s + 1) & 1) * stage_bytes, tiles, t_next, bm, bn, sweep);
    if constexpr (FUSE_DLD)
      if (s > 0) flush_dld(dld_s + ((s - 1) & 1) * n_cw * bm, rb_prev);
    rb_prev = rb_cur;
    rb_cur = rb_next;
    rb_next = rb_after;
    t_next = t_after;
    const unsigned char* adj_s = smem + (s & 1) * stage_bytes;
    const float* ld_s = reinterpret_cast<const float*>(adj_s + bm * apitch);
    const float* lse_s = ld_s + bm;
    const float* delta_s = ld_s + 2 * bm;
    const uint32_t* rk_s = reinterpret_cast<const uint32_t*>(ld_s + 3 * bm);
    const float* g_s = ld_s + 4 * bm;
    float* dld_part = dld_s + (s & 1) * n_cw * bm + cq * bm;

#pragma unroll 2
    for (int i0 = rh * half; i0 < rh * half + half; i0 += 8)
      bwd_col_patch<D, VT, DROP, FUSE_DLD>(
          adj_s, apitch, g_s, ld_s, lse_s, delta_s, rk_s, 0, i0, j0, gq, tq, va, ls_j, col_key,
          slope, drop.thresh, drop.scale, dls_j, dv_acc, dld_part, [&] {
            if (more && i0 - rh * half < bm / 4) next.copy(sweep);
          });
    cp_async_commit();
  }
  __syncthreads();  // every warp is done with the last tile
  if constexpr (FUSE_DLD)
    if (count > 0) flush_dld(dld_s + ((count - 1) & 1) * n_cw * bm, rb_prev);

  // dls over the quad (the thread's rows), then the two row halves in a
  // fixed order (half 1 through shared memory); written once per column
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) {
    dls_j[j4] += __shfl_xor_sync(FULL_MASK, dls_j[j4], 1);
    dls_j[j4] += __shfl_xor_sync(FULL_MASK, dls_j[j4], 2);
  }
  float* red_s = reinterpret_cast<float*>(smem);  // dls [bn], dv [bn][D]
  float* dvr_s = red_s + bn;
  if (rh == 1) {
    if (tq == 0)
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) red_s[j0 + j4] = dls_j[j4];
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int nt = 0; nt < KD; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + 2 * tile + (e >> 1), d = 8 * nt + 2 * tq + (e & 1);
          if (D >= 8 || d < D) dvr_s[col * D + d] = dv_acc[tile][nt][e];
        }
  }
  __syncthreads();
  if (rh != 0) return;
  if (tq == 0)
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
      dls[(size_t)h * n_cols + (size_t)cb * bn + j0 + j4] = dls_j[j4] + red_s[j0 + j4];
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int nt = 0; nt < KD; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + 2 * tile + (e >> 1), d = 8 * nt + 2 * tq + (e & 1);
        if (D >= 8 || d < D)
          dv[((size_t)cb * bn + col) * kd + hc * D + d] =
              dv_acc[tile][nt][e] + dvr_s[col * D + d];
      }
}

// ---------------------------------------------------------------------------
// the wide fused backward (head chunks of D = 64): block (column block cb,
// head chunk), 128 x 128 tiles, two warpgroups of 64 columns; thread (g, t)
// of warp w of warpgroup q owns columns j0 = 64 q + 16 w + 2 g and j0 + 1,
// which are rows g and g + 8 of the warpgroup's m64 side. A tile sweeps as
// 8 windows of 16 rows: gv = V.G^T on wgmma (m64n16k8 over the 8 k8 steps
// of D; A = the block's v in registers, split once a block; B = the
// window's g, K-major as it lies), then the elements (c, c', dz, dls, dld)
// in gv's accumulator registers, then dv += C'.G on wgmma (m64n64k8 over
// the window's two k8 steps; A = c' in the same registers, k index t (t +
// 4) of step s being row 8 s + 2 t (+1) of the window; B = the window's g
// transposed). The window's g lands by cp.async and is split into TF32 hi
// and lo in both layouts once for both warpgroups. dld: each warp's sums
// of its 16 rows over its columns (shuffles), the warps' added in shared
// memory and one atomicAdd a row and window.
// ---------------------------------------------------------------------------

constexpr int BW_D = 64;                   // the head chunk of the wide backward
constexpr int BW_RP = BW_D + 8;            // floats a landed row of g takes
constexpr int BW_PL = WIN * BW_D;          // floats of one plane of a split window
constexpr int BW_WIN_FLOATS = 4 * BW_PL;   // g as gv's B (hi, lo), transposed as dv's (hi, lo)
constexpr int BW_TILE_BYTES = WIDE_BM * (WIDE_BM + APAD) + 4 * WIDE_BM * 4;  // + ld, lse, delta, keys

__host__ __device__ constexpr int bwd_wide_smem_bytes() {
  return NSPLIT * BW_WIN_FLOATS * 4 + (RAW_AHEAD + 1) * WIN * BW_RP * 4 + 2 * BW_TILE_BYTES +
         2 * 8 * WIN * 4;  // + the warps' dld sums of two windows
}

template <typename VT, bool DROP>
__device__ __forceinline__ void bwd_wide(
    const int8_t* __restrict__ tiles, const int* __restrict__ bcount,
    const int* __restrict__ brow, const int* __restrict__ btile, int r_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dld, float* __restrict__ dls, float* __restrict__ dv,
    int n_rows, int n_cols, int k, int nc, float slope, Drop drop, Offsets off, Batch batch) {
  constexpr int D = BW_D, bm = WIDE_BM, bn = WIDE_BM, apitch = bn + APAD, NWIN = bm / WIN;
  constexpr bool V_EXACT = std::is_same<VT, __nv_bfloat16>::value;  // v has no lo part
  constexpr int NR = RAW_AHEAD + 1;
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* win_s = reinterpret_cast<float*>(smem_b);                  // NSPLIT split windows
  float* raw_s = win_s + NSPLIT * BW_WIN_FLOATS;                    // NR landed windows
  unsigned char* tile_s = reinterpret_cast<unsigned char*>(raw_s + NR * WIN * BW_RP);
  float* dldp_s = reinterpret_cast<float*>(tile_s + 2 * BW_TILE_BYTES);  // [2][8][WIN]

  // head h's chunk hc - h * nc: its columns of v, g and dv start at hc * D
  const int cb = blockIdx.x, hc = blockIdx.y, h = hc / nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3, wi = tid >> 5;
  const int j0 = 64 * (wi >> 2) + 16 * (wi & 3) + 2 * gq;  // this thread's columns j0, j0 + 1
  const int kd = k * nc * D;

  // this block's path of a batched launch (Batch); delta, dld and dls are
  // [P][nc][k][n]: this block's (path, chunk) slice
  const size_t pr = (size_t)blockIdx.z * n_rows, pc = (size_t)blockIdx.z * n_cols;
  const size_t pq = (size_t)blockIdx.z * nc + (hc - h * nc);
  tiles += (size_t)blockIdx.z * batch.t_pitch * bm * bn;
  bcount += pc / bn;
  brow += pc / bn * r_pitch;
  btile += pc / bn * r_pitch;
  ld += pr * k;
  ls += pc * k;
  v += pc * kd;
  g += pr * kd;
  lse += pr * k;
  delta += pq * k * n_rows;
  dld += pq * k * n_rows;
  dls += pq * k * n_cols;
  dv += pc * kd;
  const PathKeys pk = path_keys<DROP>(drop, off, batch, blockIdx.z);
  const uint32_t head_key = DROP ? drop_head_key(pk.seed, off.head + h) : 0u;

  // per column: ls, the dropout column half; v as gv's A operand, split
  // once: a0 (column j0, d = 8 kk + t), a1 (j0 + 1, d), a2 (j0, d + 4),
  // a3 (j0 + 1, d + 4)
  float ls_j[2];
  uint32_t col_key[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    ls_j[c] = ls[(size_t)h * n_cols + (size_t)cb * bn + j0 + c];
    col_key[c] = DROP ? drop_half((uint32_t)((off.col_block + cb) * bn + j0 + c) * GOLDEN) : 0u;
  }
  uint32_t va_hi[D / 8][4], va_lo[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const Tf32x2 a = split_tf32(
          to_f32(v[((size_t)cb * bn + j0 + (x & 1)) * kd + hc * D + 8 * kk + tq + 4 * (x >> 1)]));
      va_hi[kk][x] = a.hi;
      va_lo[kk][x] = a.lo;
    }
  // dv: the hi.hi terms apart from the small ones; dls over the walk
  float dv_hh[D / 2], dv_sm[D / 2], dls_j[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dv_hh[e] = dv_sm[e] = 0.f;

  const int count = __shfl_sync(FULL_MASK, bcount[cb], 0);
  const int* step_row = brow + (size_t)cb * r_pitch;
  const int* step_tile = btile + (size_t)cb * r_pitch;
  const int total = count * NWIN;

  // Window wq of the walk (16 rows of g) lands by cp.async in landed buffer
  // wq % NR, with, at a tile's first window, the tile's adjacency, ld, lse,
  // delta and row keys in tile buffer s % 2: one commit group a window.
  auto land = [&](int wq) {
    if (wq < total) {
      const int s = wq / NWIN, w8 = wq - s * NWIN, rb = step_row[s];
      const int r = tid >> 4, c4 = tid & 15;  // one 16-byte copy a thread
      cp_async<16>(raw_s + (wq & (NR - 1)) * WIN * BW_RP + r * BW_RP + 4 * c4,
                   g + ((size_t)rb * bm + WIN * w8 + r) * kd + hc * D + 4 * c4);
      if (w8 == 0) {
        unsigned char* buf = tile_s + (s & 1) * BW_TILE_BYTES;
        const unsigned char* adj =
            reinterpret_cast<const unsigned char*>(tiles) + (size_t)step_tile[s] * bm * bn;
#pragma unroll
        for (int j = 0; j < bm * bn / 16 / WIDE_THREADS; ++j) {
          const int i = tid + j * WIDE_THREADS, rr = i / (bn / 16), q = i - rr * (bn / 16);
          cp_async<16>(buf + rr * apitch + 16 * q, adj + rr * bn + 16 * q);
        }
        float* vec_s = reinterpret_cast<float*>(buf + bm * apitch);
        const size_t hr = (size_t)h * n_rows + (size_t)rb * bm;
        if (tid < 96) {  // ld, lse, delta: 32 copies each
          const float* src = tid < 32 ? ld : tid < 64 ? lse : delta;
          cp_async<16>(vec_s + (tid >> 5) * bm + 4 * (tid & 31), src + hr + 4 * (tid & 31));
        }
        if constexpr (DROP) {  // the row keys, hashed once a row and tile
          uint32_t* rk_s = reinterpret_cast<uint32_t*>(vec_s + 3 * bm);
          for (int i = tid; i < bm; i += WIDE_THREADS)
            rk_s[i] = drop_half(drop_row_key(head_key, (uint32_t)((pk.row_block + rb) * bm + i)));
        }
      }
    }
    cp_async_commit();
  };
  // Landed window wq split into TF32 hi and lo (split_tf32) in split buffer
  // wq % NSPLIT, once for both warpgroups, in two layouts. As gv's B (k = d,
  // n = row i): core matrix (i / 8, d % 8 / 4) of k step d / 8 at (d / 8)
  // 128 + (i / 8) 64 + (d % 8 / 4) 32 floats, row i % 8 at 4 (i % 8), value
  // d % 4 (lbo 128 bytes, sbo 256): one 16-byte load and two stores a
  // thread. As dv's B (k = row, n = d): wide_off<64>(i / 8, d, k) with k =
  // (i % 8) / 2 + 4 (i % 2): four loads and two 16-byte stores a thread.
  auto split = [&](int wq) {
    const float* src = raw_s + (wq & (NR - 1)) * WIN * BW_RP;
    float* dst = win_s + (wq % NSPLIT) * BW_WIN_FLOATS;
    {
      const int i = tid & 15, q = tid >> 4;  // row, head-dim quad
      const float4 x = *reinterpret_cast<const float4*>(src + i * BW_RP + 4 * q);
      const Tf32x2 y[4] = {split_tf32(x.x), split_tf32(x.y), split_tf32(x.z), split_tf32(x.w)};
      const int o = (q >> 1) * 128 + (i >> 3) * 64 + (q & 1) * 32 + (i & 7) * 4;
      *reinterpret_cast<float4*>(dst + o) =
          make_float4(__uint_as_float(y[0].hi), __uint_as_float(y[1].hi),
                      __uint_as_float(y[2].hi), __uint_as_float(y[3].hi));
      *reinterpret_cast<float4*>(dst + BW_PL + o) =
          make_float4(__uint_as_float(y[0].lo), __uint_as_float(y[1].lo),
                      __uint_as_float(y[2].lo), __uint_as_float(y[3].lo));
    }
    {
      // head-dim index d = 8 d8 + (lane & 7), k step s, k quad e: the rows
      // 8 s + e + 2 u (u < 4) are k indices 4 e + u
      const int s = wi & 1, e = (lane >> 3) & 1;
      const int d8 = ((wi >> 1) & 1) + 2 * ((lane >> 4) & 1) + 4 * (wi >> 2);
      const int d = 8 * d8 + (lane & 7);
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = src[(8 * s + e + 2 * u) * BW_RP + d];
      const Tf32x2 y[4] = {split_tf32(x[0]), split_tf32(x[1]), split_tf32(x[2]), split_tf32(x[3])};
      float4* o = reinterpret_cast<float4*>(dst + 2 * BW_PL + wide_off<D>(s, d, 4 * e));
      o[0] = make_float4(__uint_as_float(y[0].hi), __uint_as_float(y[1].hi),
                         __uint_as_float(y[2].hi), __uint_as_float(y[3].hi));
      o[BW_PL / 4] = make_float4(__uint_as_float(y[0].lo), __uint_as_float(y[1].lo),
                                 __uint_as_float(y[2].lo), __uint_as_float(y[3].lo));
    }
    fence_async_smem();
  };
  // window wq's dld: the warps' sums added, one atomicAdd a row
  auto flush_dld = [&](int wq) {
    if (tid < WIN) {
      const float* part = dldp_s + (wq & 1) * 8 * WIN;
      float x = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) x += part[q * WIN + tid];
      const int s = wq / NWIN;
      atomicAdd(&dld[(size_t)h * n_rows + (size_t)step_row[s] * bm + WIN * (wq - s * NWIN) + tid],
                x);
    }
  };

  if (total > 0) {
#pragma unroll
    for (int j = 0; j <= RAW_AHEAD; ++j) land(j);
    cp_async_wait<RAW_AHEAD - 1>();  // windows 0 and 1, tile 0
    __syncthreads();
    split(0);
  }
  // Window wq: gv's products, then, while they run, window wq + 1 split
  // and window wq + 1 + RAW_AHEAD sent on its way; the elements; dv's
  // products. A turn of the loop takes two windows: the first's dv products
  // run on behind the second's barrier, flush and gv products, and both are
  // waited for at the turn's end, so that none is in flight across the
  // loop's back edge (where the compiler would move accumulators).
  uint32_t ahi[2][2][4], alo[2][2][4];  // dv's A registers of a pair's windows
  auto step = [&](int wq, auto par) {
    constexpr int P = decltype(par)::value;
    __syncthreads();  // window wq is split; its tile's vectors and the last window's dld sums are in
    if (wq > 0) flush_dld(wq - 1);
    const float* wb = win_s + (wq % NSPLIT) * BW_WIN_FLOATS;
    // gv = V.G^T over the window's 16 rows: lo.hi, hi.lo, then hi.hi
    float gv_hh[8], gv_sm[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) gv_hh[e] = gv_sm[e] = 0.f;
    {
      const uint64_t desc = wg_desc(wb, 128, 256);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t bhi = desc + (uint64_t)(kk * 128 / 4);  // 16-byte units
        if constexpr (!V_EXACT) wgmma_tf32(gv_sm, va_lo[kk], bhi);
        wgmma_tf32(gv_sm, va_hi[kk], bhi + BW_PL / 4);
        wgmma_tf32(gv_hh, va_hi[kk], bhi);
      }
      wg_commit();
    }
    // while the products run: window wq + 1 split, window wq + 1 +
    // RAW_AHEAD on its way
    if (wq + 1 < total) split(wq + 1);
    land(wq + 1 + RAW_AHEAD);
    wg_wait<0>();  // gv's products (and the pair's first dv products)
    wg_pin(gv_hh);
    wg_pin(gv_sm);

    // the elements: gv entry 4 n + 2 c + r is column j0 + c, row ia + 8 n +
    // r of the tile (ia = WIN w + 2 t): c = exp(z - lse) on edges (a
    // select: off-edge exp may be +inf), c' = c keep / (1 - p), dz = (c' gv
    // - c delta) lrelu'
    const int s = wq / NWIN, w8 = wq - s * NWIN;
    const unsigned char* adj_s = tile_s + (s & 1) * BW_TILE_BYTES;
    const float* ld_s = reinterpret_cast<const float*>(adj_s + bm * apitch);
    const float* lse_s = ld_s + bm;
    const float* delta_s = ld_s + 2 * bm;
    const uint32_t* rk_s = reinterpret_cast<const uint32_t*>(ld_s + 3 * bm);
    float cd[8], row_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int ia = WIN * w8 + 8 * n + 2 * tq;
      const float2 ld2 = *reinterpret_cast<const float2*>(ld_s + ia);
      const float2 lse_n = *reinterpret_cast<const float2*>(lse_s + ia);
      const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + ia);
      const uint2 rk2 = DROP ? *reinterpret_cast<const uint2*>(rk_s + ia) : make_uint2(0u, 0u);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t bits = *reinterpret_cast<const unsigned short*>(adj_s + (ia + r) * apitch + j0);
        const float ldr = r ? ld2.y : ld2.x, lse2 = (r ? lse_n.y : lse_n.x) * LOG2E;
        const float dlt = r ? dl2.y : dl2.x;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * n + 2 * c + r;
          const float raw = ldr + ls_j[c];
          const float zz = fmaxf(raw, slope * raw);
          const float ce = ex2(fmaf(zz, LOG2E, -lse2));
          const float cc = (bits & (0xffu << (8 * c))) ? ce : 0.f;
          float c_agg = cc;
          if constexpr (DROP)
            c_agg = drop_tail((r ? rk2.y : rk2.x) ^ col_key[c]) < drop.thresh ? cc * drop.scale
                                                                           : 0.f;
          const float dz = fmaf(c_agg, gv_sm[e] + gv_hh[e], -cc * dlt);
          const float dzs = raw >= 0.f ? dz : slope * dz;
          dls_j[c] += dzs;
          row_sum[n][r] += dzs;
          cd[e] = c_agg;
        }
      }
    }
    // this warp's dld of the window's rows: its 16 columns (the 8 lanes of g)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = row_sum[n][r];
        x += __shfl_xor_sync(FULL_MASK, x, 4);
        x += __shfl_xor_sync(FULL_MASK, x, 8);
        x += __shfl_xor_sync(FULL_MASK, x, 16);
        if (gq == 0) dldp_s[(wq & 1) * 8 * WIN + wi * WIN + 8 * n + 2 * tq + r] = x;
      }
    // dv += C'.G over the window's two k steps: a = (cd0, cd2, cd1, cd3) of
    // step n; lo.hi, hi.lo, then hi.hi
    {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const Tf32x2 a = split_tf32(cd[4 * n + 2 * (x & 1) + (x >> 1)]);
          ahi[P][n][x] = a.hi;
          alo[P][n][x] = a.lo;
        }
      const uint64_t desc = wg_desc(wb + 2 * BW_PL, 128, 256);
      wg_fence();
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint64_t bhi = desc + (uint64_t)(n * 8 * D / 4);
        wgmma_tf32(dv_sm, alo[P][n], bhi);
        wgmma_tf32(dv_sm, ahi[P][n], bhi + BW_PL / 4);
        wgmma_tf32(dv_hh, ahi[P][n], bhi);
      }
      wg_commit();
    }
    cp_async_wait<RAW_AHEAD - 1>();  // window wq + 2 (and its tile) has landed
  };
  for (int wq = 0; wq < total; wq += 2) {
    step(wq, std::integral_constant<int, 0>{});
    if (wq + 1 < total) step(wq + 1, std::integral_constant<int, 1>{});
    wg_wait<0>();
    wg_pin(dv_hh);
    wg_pin(dv_sm);
  }
  __syncthreads();  // the last window's dld sums
  if (total > 0) flush_dld(total - 1);

  // dls over the quad (the thread's rows); dv, written once
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float x = dls_j[c] + __shfl_xor_sync(FULL_MASK, dls_j[c], 1);
    x += __shfl_xor_sync(FULL_MASK, x, 2);
    if (tq == 0) dls[(size_t)h * n_cols + (size_t)cb * bn + j0 + c] = x;
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float* o = dv + ((size_t)cb * bn + j0 + c) * kd + hc * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int e = 4 * n + 2 * c;
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(dv_sm[e] + dv_hh[e], dv_sm[e + 1] + dv_hh[e + 1]);
    }
  }
}

// The column sweep: the fused backward's wide body at D = 64 (128 x 128
// tiles; a wider head in chunks of 64), else the narrow one.
template <int D, bool FUSE_DLD, typename VT, bool DROP>
__global__ void __launch_bounds__(D >= 64 ? WIDE_THREADS : 512) bwd_col_kernel(
    const int8_t* __restrict__ tiles, const int* __restrict__ bcount,
    const int* __restrict__ brow, const int* __restrict__ btile, int r_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dld, float* __restrict__ dls, float* __restrict__ dv,
    int n_rows, int n_cols, int bm, int bn, int k, int nc, float slope, Drop drop,
    Offsets off, Batch batch) {
  if constexpr (D >= 64) {
    static_assert(D == BW_D && FUSE_DLD, "the wide body is the fused backward's, at D = 64");
    bwd_wide<VT, DROP>(tiles, bcount, brow, btile, r_pitch, ld, ls, v, g, lse, delta, dld, dls,
                       dv, n_rows, n_cols, k, nc, slope, drop, off, batch);
  } else {
    bwd_narrow<D, FUSE_DLD, VT, DROP>(tiles, bcount, brow, btile, r_pitch, ld, ls, v, g, lse,
                                      delta, dld, dls, dv, n_rows, n_cols, bm, bn, k, nc, slope,
                                      drop, off, batch);
  }
}

// ---------------------------------------------------------------------------
// split backward, row sweep: block (row block rb, head h) over the forward
// map, bm / 16 warps, laid out as fwd_kernel: warp w owns rows 16 w ..
// 16 w + 15 of the block, thread (g, t) rows r_lo = 16 w + g and r_lo + 8
// and, in each 32-column chunk, the columns c0 + 16 u + 4 t + b (window u,
// b < 4): one adjacency word a row and window. g.v^T of a 16-column window
// is two m16n8k8 products (n8 tiles hh = 0, 1), g's 16 x D rows the A
// operand (split once a block: the block's rows never change) and the
// staged v columns the B operand; n index 2 t + e of tile hh is column
// 4 t + 2 hh + e, so each product lands in the fragment positions where the
// forward holds its logits. Writes dld only, once a row: no atomics.
// ---------------------------------------------------------------------------

// The xor that places element (c, d) of a staged v tile for the row sweep:
// v_s[(c D + d) ^ row_vswz<D, VT>(c)]. It is a function of c's low 4 bits
// that flips only lower bits of the offset (d's bits, or c's bit 1 at D =
// 4), in whole cp.async chunks, so it permutes within a 16-column window.
// Lane (g, t) of a B fragment reads column 4 (g >> 1) + 2 hh + (g & 1) of a
// window at d = 8 kk + t (+ 4): the lanes vary c's bits 0, 2 and 3 and d's
// bits 0 and 1, and the xor moves the c bits that fall outside the bank
// bits onto bank bits that are the same across the lanes, so the 32 reads
// hit 32 banks (bf16: 16 words, two lanes a word, in 16 banks).
template <int D, typename VT>
__device__ __forceinline__ int row_vswz(int c) {
  if constexpr (sizeof(VT) == 4) {
    if constexpr (D == 4) return c & 8;
    else if constexpr (D == 8) return ((c & 4) << 2) | ((c & 8) >> 1);
    else if constexpr (D == 16) return c & 12;
    else return ((c & 1) << 2) | ((c & 12) << 1);
  } else {
    if constexpr (D == 4) return 0;
    else if constexpr (D == 8) return (c & 8) << 1;
    else if constexpr (D == 16) return ((c & 4) << 1) | ((c & 8) << 2);
    else return (c & 12) << 1;
  }
}

template <int D, typename VT, bool DROP>
__global__ void __launch_bounds__(512) bwd_row_kernel(
    const int8_t* __restrict__ tiles, const int* __restrict__ fcount,
    const int* __restrict__ fcol, const int* __restrict__ ftile, int c_pitch,
    const float* __restrict__ ld, const float* __restrict__ ls,
    const VT* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dld, int n_rows, int n_cols, int bm, int bn, int k,
    int nc, float slope, Drop drop, Offsets off, Batch batch) {
  constexpr int KD = (D + 7) / 8;              // k8 steps of g.v
  constexpr int VCOL = D * (int)sizeof(VT);    // bytes of one column of v
  constexpr int VCH = VCOL < 16 ? VCOL : 16;   // cp.async size for v
  constexpr int VCHE = VCH / (int)sizeof(VT);  // elements of a copy
  constexpr bool V_EXACT = std::is_same<VT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int apitch = bn + APAD;
  const int stage_bytes = fwd_stage_bytes(bm, bn, D, sizeof(VT));

  // head h's chunk hc - h * nc: its columns of v and g start at hc * D
  const int rb = blockIdx.x, hc = blockIdx.y, h = hc / nc;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r_lo = (tid >> 5) * 16 + gq;  // rows r_lo and r_lo + 8
  const int kd = k * nc * D;

  // this block's path of a batched launch (Batch); delta and dld are
  // [P][nc][k][n]: this block's (path, chunk) slice
  const size_t pr = (size_t)blockIdx.z * n_rows, pc = (size_t)blockIdx.z * n_cols;
  const size_t pq = (size_t)blockIdx.z * nc + (hc - h * nc);
  tiles += (size_t)blockIdx.z * batch.t_pitch * bm * bn;
  fcount += pr / bm;
  fcol += pr / bm * c_pitch;
  ftile += pr / bm * c_pitch;
  ld += pr * k;
  ls += pc * k;
  v += pc * kd;
  g += pr * kd;
  lse += pr * k;
  delta += pq * k * n_rows;
  dld += pq * k * n_rows;
  const PathKeys pk = path_keys<DROP>(drop, off, batch, blockIdx.z);

  // per row: ld, lse (log2 domain), delta, the dropout row key
  const uint32_t head_key = DROP ? drop_head_key(pk.seed, off.head + h) : 0u;
  float ld_r[2], lse2[2], delta_r[2], acc[2];
  uint32_t row_key[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r_lo + 8 * rr;
    const size_t hr = (size_t)h * n_rows + (size_t)rb * bm + r;
    ld_r[rr] = ld[hr];
    lse2[rr] = lse[hr] * LOG2E;
    delta_r[rr] = delta[hr];
    row_key[rr] = DROP ? drop_half(drop_row_key(head_key,
                                                (uint32_t)((pk.row_block + rb) * bm + r)))
                       : 0u;
    acc[rr] = 0.f;
  }
  // g as the A operand of g.v^T: a0 (row r_lo, d = t), a1 (r_lo + 8, t),
  // a2 (r_lo, t + 4), a3 (r_lo + 8, t + 4), d + 8 kk at k step kk
  Tf32x2 ga[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int idx = 0; idx < 4; ++idx) {
      const int r = r_lo + 8 * (idx & 1), d = 8 * kk + tq + 4 * (idx >> 1);
      ga[kk][idx] = split_tf32(
          d < D ? g[((size_t)rb * bm + r) * kd + hc * D + d] : 0.f);
    }
  // this thread's B-fragment offsets in a staged window: column
  // 4 (g >> 1) + 2 hh + (g & 1), d = 8 kk + t + 4 j, after the swizzle
  int vo[2][KD][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int cw = 4 * (gq >> 1) + 2 * hh + (gq & 1);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        vo[hh][kk][j] = (cw * D + 8 * kk + tq + 4 * j) ^ row_vswz<D, VT>(cw);
  }

  const int count = fcount[rb];
  const int* step_col = fcol + (size_t)rb * c_pitch;
  const int* step_tile = ftile + (size_t)rb * c_pitch;
  const AdjSweep sweep(bn, tid, nthr);

  // the ls and v slices of step s (and the column halves of the dropout
  // hash); its adjacency goes through an AdjCursor
  auto stage_slices = [&](int s, int cb) {
    unsigned char* buf = smem + (s & 1) * stage_bytes;
    float* ls_s = reinterpret_cast<float*>(buf + bm * apitch);
    stage_floats(ls_s, ls + (size_t)h * n_cols + (size_t)cb * bn, bn, tid, nthr);
    if constexpr (DROP) {
      uint32_t* ck_s = reinterpret_cast<uint32_t*>(ls_s + bn);
      for (int c = tid; c < bn; c += nthr)
        ck_s[c] = drop_half((uint32_t)((off.col_block + cb) * bn + c) * GOLDEN);
    }
    VT* v_s = reinterpret_cast<VT*>(ls_s + 2 * bn);
    constexpr int VQ = VCOL / VCH;
    for (int i = tid; i < bn * VQ; i += nthr) {
      const int c = i / VQ, q = i - c * VQ;
      cp_async<VCH>(v_s + ((c * D + q * VCHE) ^ row_vswz<D, VT>(c)),
                    v + ((size_t)cb * bn + c) * kd + hc * D + q * VCHE);
    }
  };

  // the map entries of steps s + 1 (next) and s + 2 (loaded a step ahead)
  int cb_next = count > 1 ? step_col[1] : 0, t_next = count > 1 ? step_tile[1] : 0;
  if (count > 0) {
    stage_slices(0, step_col[0]);
    AdjCursor first(smem, tiles, step_tile[0], bm, bn, sweep);
    for (int j = 0; j < bn / 32; ++j) first.copy(sweep);
    cp_async_commit();
  }
  for (int s = 0; s < count; ++s) {
    const int cb_after = s + 2 < count ? step_col[s + 2] : 0;
    const int t_after = s + 2 < count ? step_tile[s + 2] : 0;
    cp_async_wait_all();
    __syncthreads();  // tile s is visible; every warp is done with tile s - 1
    // tile s + 1 lands while tile s computes: its slices now, its adjacency
    // a part (one chunk a thread) per 32-column chunk
    const bool more = s + 1 < count;
    if (more) stage_slices(s + 1, cb_next);
    AdjCursor next(smem + ((s + 1) & 1) * stage_bytes, tiles, t_next, bm, bn, sweep);
    const unsigned char* adj_s = smem + (s & 1) * stage_bytes;
    const float* ls_s = reinterpret_cast<const float*>(adj_s + bm * apitch);
    const uint32_t* ck_s = reinterpret_cast<const uint32_t*>(ls_s + bn);
    const VT* v_s = reinterpret_cast<const VT*>(ls_s + 2 * bn);
    cb_next = cb_after;
    t_next = t_after;

#pragma unroll 2
    for (int c0 = 0; c0 < bn; c0 += 32) {
      // gv = g.v^T: gv[u][hh][e] is row r_lo + 8 (e >> 1), column
      // c0 + 16 u + 4 t + 2 hh + (e & 1)
      float gv[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const VT* vw = v_s + (c0 + 16 * u) * D;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[u][hh][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            const Tf32x2 b[2] = {split_tf32(to_f32(vw[vo[hh][kk][0]])),
                                 D >= 8 ? split_tf32(to_f32(vw[vo[hh][kk][1]]))
                                        : Tf32x2{0u, 0u}};
            mma_3xtf32<false, V_EXACT>(gv[u][hh], gv[u][hh], gv[u][hh], ga[kk], b);
          }
        }
      }
      if (more) next.copy(sweep);
      // the elements, branch-free: c = exp(z - lse) on edges (a select, not
      // a multiply: off-edge exp may be +inf), dz = c (keep' g.v - delta)
      // folded with lrelu', summed per row
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = c0 + 16 * u + 4 * tq;
        const float4 l4 = *reinterpret_cast<const float4*>(ls_s + c);
        const float lsv[4] = {l4.x, l4.y, l4.z, l4.w};
        uint32_t key[4] = {0u, 0u, 0u, 0u};
        if constexpr (DROP) {
          const uint4 k4 = *reinterpret_cast<const uint4*>(ck_s + c);
          key[0] = k4.x;
          key[1] = k4.y;
          key[2] = k4.z;
          key[3] = k4.w;
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const uint32_t bits =
              *reinterpret_cast<const uint32_t*>(adj_s + (r_lo + 8 * rr) * apitch + c);
          float dzs[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float raw = ld_r[rr] + lsv[b];
            const float zz = fmaxf(raw, slope * raw);
            const float ce = ex2(fmaf(zz, LOG2E, -lse2[rr]));
            const float cc = (bits & (0xffu << (8 * b))) ? ce : 0.f;
            const float gvv = gv[u][b >> 1][2 * rr + (b & 1)];
            float t = gvv - delta_r[rr];
            if constexpr (DROP) {
              const float ks =
                  drop_tail(row_key[rr] ^ key[b]) < drop.thresh ? drop.scale : 0.f;
              t = fmaf(ks, gvv, -delta_r[rr]);
            }
            const float dz = cc * t;
            dzs[b] = raw >= 0.f ? dz : slope * dz;
          }
          acc[rr] += (dzs[0] + dzs[1]) + (dzs[2] + dzs[3]);
        }
      }
    }
    cp_async_commit();
  }

  // dld: the quad's partial sums in a fixed order, one store a row
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float x = acc[rr] + __shfl_xor_sync(FULL_MASK, acc[rr], 1);
    x += __shfl_xor_sync(FULL_MASK, x, 2);
    if (tq == 0) dld[(size_t)h * n_rows + (size_t)rb * bm + r_lo + 8 * rr] = x;
  }
}

// The geometry every kernel takes: bm and bn multiples of 32 up to 256, so
// that the 16-row warps of fwd_kernel and bwd_row_kernel and
// bwd_col_kernel's 32-column warps and 8-row patches tile the blocks
// (graph/bcsr.py:tile_error says the same in Python).
bool bad_geometry(int n_rows, int n_cols, int bm, int bn, int k, int nc) {
  return bm <= 0 || bn <= 0 || bm % 32 || bn % 32 || bm > 256 || bn > 256 ||
         n_rows % bm || n_cols % bn || k <= 0 || nc <= 0 || k * nc > 65535;
}

size_t fwd_smem(int bm, int bn, int d, int vbytes) {
  return 2 * (size_t)fwd_stage_bytes(bm, bn, d, vbytes);
}

size_t bwd_smem(int bm, int bn, int d, bool fuse_dld) {
  const size_t body = std::max(2 * (size_t)bwd_stage_bytes(bm, bn, d),
                               (size_t)bn * (d + 1) * 4);  // stages, or the merge
  return body + (fuse_dld ? 2 * (size_t)(bn / 32) * bm * 4 : 0);
}

template <int D, typename VT, bool DROP>
int launch_fwd(const void* tiles, const void* fcount, const void* fcol,
               const void* ftile, int c_pitch, const void* ld, const void* ls,
               const void* v, void* out, void* lse, int n_rows, int n_cols,
               int bm, int bn, int k, int nc, float slope, Drop drop, Offsets off,
               int n_paths, Batch batch, cudaStream_t stream) {
  size_t smem = fwd_smem(bm, bn, D, sizeof(VT));
  if constexpr (D >= 64) {  // the wide body: two warpgroups of 64 rows
    if (bm != WIDE_BM || bn != WIDE_BM) return (int)cudaErrorInvalidValue;
    smem = wide_smem_bytes<D, VT>();
  }
  cudaError_t err = set_smem(fwd_kernel<D, VT, DROP>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<D, VT, DROP><<<dim3(n_rows / bm, k * nc, n_paths), 2 * bm, smem, stream>>>(
      (const int8_t*)tiles, (const int*)fcount, (const int*)fcol,
      (const int*)ftile, c_pitch, (const float*)ld, (const float*)ls,
      (const VT*)v, (float*)out, (float*)lse, n_rows, n_cols, bm, bn, k, nc,
      slope, drop, off, batch);
  return (int)cudaGetLastError();
}

template <int D, bool FUSE_DLD, typename VT, bool DROP>
int launch_bwd(const void* tiles, const void* bcount, const void* brow,
               const void* btile, int r_pitch, const void* ld, const void* ls,
               const void* v, const void* g, const void* lse,
               const void* delta, void* dld, void* dls, void* dv, int n_rows,
               int n_cols, int bm, int bn, int k, int nc, float slope, Drop drop,
               Offsets off, int n_paths, Batch batch, cudaStream_t stream) {
  size_t smem = bwd_smem(bm, bn, D, FUSE_DLD);
  if constexpr (D >= 64) {  // the wide body: two warpgroups of 64 columns
    if (bm != WIDE_BM || bn != WIDE_BM) return (int)cudaErrorInvalidValue;
    smem = bwd_wide_smem_bytes();
  }
  cudaError_t err = set_smem(bwd_col_kernel<D, FUSE_DLD, VT, DROP>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_col_kernel<D, FUSE_DLD, VT, DROP>
      <<<dim3(n_cols / bn, k * nc, n_paths), 2 * bn, smem, stream>>>(
          (const int8_t*)tiles, (const int*)bcount, (const int*)brow,
          (const int*)btile, r_pitch, (const float*)ld, (const float*)ls,
          (const VT*)v, (const float*)g, (const float*)lse,
          (const float*)delta, (float*)dld, (float*)dls, (float*)dv, n_rows,
          n_cols, bm, bn, k, nc, slope, drop, off, batch);
  return (int)cudaGetLastError();
}

template <int D, typename VT, bool DROP>
int launch_bwd_row(const void* tiles, const void* fcount, const void* fcol,
                   const void* ftile, int c_pitch, const void* ld,
                   const void* ls, const void* v, const void* g,
                   const void* lse, const void* delta, void* dld, int n_rows,
                   int n_cols, int bm, int bn, int k, int nc, float slope, Drop drop,
                   Offsets off, int n_paths, Batch batch, cudaStream_t stream) {
  const size_t smem = fwd_smem(bm, bn, D, sizeof(VT));
  cudaError_t err = set_smem(bwd_row_kernel<D, VT, DROP>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_row_kernel<D, VT, DROP><<<dim3(n_rows / bm, k * nc, n_paths), 2 * bm, smem, stream>>>(
      (const int8_t*)tiles, (const int*)fcount, (const int*)fcol,
      (const int*)ftile, c_pitch, (const float*)ld, (const float*)ls,
      (const VT*)v, (const float*)g, (const float*)lse,
      (const float*)delta, (float*)dld, n_rows, n_cols, bm, bn, k, nc, slope,
      drop, off, batch);
  return (int)cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(dim, tag, drop) with the head dim d (4, 8, 16 or 32; WIDE: also
// the wide bodies' widths, 64 and, with WIDE > 1, 128: the forward takes
// both, the fused backward 64) as an std::integral_constant,
// v's element type (float, or bf16 when v_bf16) as a Tag and whether
// dropout is on as an std::bool_constant.
template <int WIDE = 0, typename F>
int dispatch(int d, int v_bf16, int drop_on, F&& f) {
  auto by_drop = [&](auto dim, auto tag) {
    return drop_on ? f(dim, tag, std::true_type{}) : f(dim, tag, std::false_type{});
  };
  auto by_type = [&](auto dim) {
    return v_bf16 ? by_drop(dim, Tag<__nv_bfloat16>{}) : by_drop(dim, Tag<float>{});
  };
  switch (d) {
    case 4: return by_type(std::integral_constant<int, 4>{});
    case 8: return by_type(std::integral_constant<int, 8>{});
    case 16: return by_type(std::integral_constant<int, 16>{});
    case 32: return by_type(std::integral_constant<int, 32>{});
    default: break;
  }
  if constexpr (WIDE > 0)
    if (d == 64) return by_type(std::integral_constant<int, 64>{});
  if constexpr (WIDE > 1)
    if (d == 128) return by_type(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

bool bad_batch(int n_paths, int t_pitch) {
  return n_paths <= 0 || n_paths > 65535 || t_pitch <= 0;
}

// The column sweep, with or without the fused dld.
template <bool FUSE_DLD>
int bwd_entry(const void* tiles, const void* bcount, const void* brow,
              const void* btile, int r_pitch, const void* ld, const void* ls,
              const void* v, const void* g, const void* lse,
              const void* delta, void* dld, void* dls, void* dv, int n_rows,
              int n_cols, int bm, int bn, int k, int d, int nc, int v_bf16,
              float slope, int drop_on, const void* seed, unsigned thresh,
              float drop_scale, int row_block_off, int head_off,
              int col_block_off, int n_paths, int t_pitch,
              const void* path_row_block, void* stream) {
  if (bad_geometry(n_rows, n_cols, bm, bn, k, nc) || bad_batch(n_paths, t_pitch))
    return (int)cudaErrorInvalidValue;
  const Drop drop{drop_on, (const uint32_t*)seed, thresh, drop_scale};
  const Offsets off{row_block_off, head_off, col_block_off};
  const Batch batch{t_pitch, (const int*)path_row_block};
  return dispatch<FUSE_DLD ? 1 : 0>(d, v_bf16, drop_on, [&](auto dim, auto tag, auto dropping) {
    return launch_bwd<decltype(dim)::value, FUSE_DLD, typename decltype(tag)::type,
                      decltype(dropping)::value>(
        tiles, bcount, brow, btile, r_pitch, ld, ls, v, g, lse, delta, dld, dls,
        dv, n_rows, n_cols, bm, bn, k, nc, slope, drop, off, n_paths, batch,
        (cudaStream_t)stream);
  });
}

}  // namespace

extern "C" {

// Every entry point sweeps n_paths graphs of one geometry in one launch
// (Batch: path p's arrays follow path p - 1's, each at the layout below;
// n_paths = 1 is one graph), each head in nc chunks of d columns (nc = 1:
// the whole head; the feature rows are k*nc*d wide, head h's chunk c at
// column (h*nc + c)*d). seed: n_paths uint32 words in device memory,
// read when drop_on (may be null when not). t_pitch: tile slots a path.
// path_row_block: n_paths int32 row-block offsets in device memory added to
// row_block_off, or null. Every array 16-byte aligned. Each returns a
// cudaError_t code (0 = launched).

// Forward. tiles int8 [T, bm, bn]; fcount int32 [nb_r]; fcol, ftile int32
// [nb_r, c_pitch]; ld f32 [k, n_rows]; ls f32 [k, n_cols]; v f32, or bf16
// when v_bf16, [n_cols, k*nc*d] -> out f32 [n_rows, k*nc*d], lse f32 [k,
// n_rows]. d is 4, 8, 16 or 32, or 64 or 128 on 128 x 128 tiles (the wide
// body).
int han_flash_fwd(const void* tiles, const void* fcount, const void* fcol,
                  const void* ftile, int c_pitch, const void* ld,
                  const void* ls, const void* v, void* out, void* lse,
                  int n_rows, int n_cols, int bm, int bn, int k, int d, int nc,
                  int v_bf16, float slope, int drop_on, const void* seed,
                  unsigned thresh, float drop_scale, int row_block_off,
                  int head_off, int col_block_off, int n_paths, int t_pitch,
                  const void* path_row_block, void* stream) {
  if (bad_geometry(n_rows, n_cols, bm, bn, k, nc) || bad_batch(n_paths, t_pitch))
    return (int)cudaErrorInvalidValue;
  const Drop drop{drop_on, (const uint32_t*)seed, thresh, drop_scale};
  const Offsets off{row_block_off, head_off, col_block_off};
  const Batch batch{t_pitch, (const int*)path_row_block};
  return dispatch<2>(d, v_bf16, drop_on, [&](auto dim, auto tag, auto dropping) {
    return launch_fwd<decltype(dim)::value, typename decltype(tag)::type,
                      decltype(dropping)::value>(
        tiles, fcount, fcol, ftile, c_pitch, ld, ls, v, out, lse, n_rows,
        n_cols, bm, bn, k, nc, slope, drop, off, n_paths, batch, (cudaStream_t)stream);
  });
}

// Fused backward (d also 64 on 128 x 128 tiles: the wide body). Adds
// bcount int32 [nb_c]; brow, btile int32 [nb_c, r_pitch];
// g f32 [n_rows, k*nc*d]; lse f32 [k, n_rows]; delta f32 [nc, k, n_rows]
// (chunk c's g.out) -> dld f32 [nc, k, n_rows] (zeroed by the caller,
// accumulated with atomicAdd), dls f32 [nc, k, n_cols] (each chunk's part
// of the sum), dv f32 [n_cols, k*nc*d] (written once; f32 whatever v's
// type).
int han_flash_bwd(const void* tiles, const void* bcount, const void* brow,
                  const void* btile, int r_pitch, const void* ld,
                  const void* ls, const void* v, const void* g,
                  const void* lse, const void* delta, void* dld, void* dls,
                  void* dv, int n_rows, int n_cols, int bm, int bn, int k,
                  int d, int nc, int v_bf16, float slope, int drop_on,
                  const void* seed, unsigned thresh, float drop_scale,
                  int row_block_off, int head_off, int col_block_off,
                  int n_paths, int t_pitch, const void* path_row_block,
                  void* stream) {
  return bwd_entry<true>(tiles, bcount, brow, btile, r_pitch, ld, ls, v, g,
                         lse, delta, dld, dls, dv, n_rows, n_cols, bm, bn, k,
                         d, nc, v_bf16, slope, drop_on, seed, thresh, drop_scale,
                         row_block_off, head_off, col_block_off, n_paths,
                         t_pitch, path_row_block, stream);
}

// Split backward, row sweep: the forward's map and the fused backward's
// float inputs -> dld f32 [nc, k, n_rows], each element written once.
int han_flash_bwd_row(const void* tiles, const void* fcount, const void* fcol,
                      const void* ftile, int c_pitch, const void* ld,
                      const void* ls, const void* v, const void* g,
                      const void* lse, const void* delta, void* dld,
                      int n_rows, int n_cols, int bm, int bn, int k, int d,
                      int nc, int v_bf16, float slope, int drop_on,
                      const void* seed, unsigned thresh, float drop_scale,
                      int row_block_off, int head_off, int col_block_off,
                      int n_paths, int t_pitch, const void* path_row_block,
                      void* stream) {
  if (bad_geometry(n_rows, n_cols, bm, bn, k, nc) || bad_batch(n_paths, t_pitch))
    return (int)cudaErrorInvalidValue;
  const Drop drop{drop_on, (const uint32_t*)seed, thresh, drop_scale};
  const Offsets off{row_block_off, head_off, col_block_off};
  const Batch batch{t_pitch, (const int*)path_row_block};
  return dispatch(d, v_bf16, drop_on, [&](auto dim, auto tag, auto dropping) {
    return launch_bwd_row<decltype(dim)::value, typename decltype(tag)::type,
                          decltype(dropping)::value>(
        tiles, fcount, fcol, ftile, c_pitch, ld, ls, v, g, lse, delta, dld,
        n_rows, n_cols, bm, bn, k, nc, slope, drop, off, n_paths, batch,
        (cudaStream_t)stream);
  });
}

// Split backward, column sweep: the backward's map and the same float
// inputs -> dls f32 [nc, k, n_cols], dv f32 [n_cols, k*nc*d], each written
// once.
int han_flash_bwd_col(const void* tiles, const void* bcount, const void* brow,
                      const void* btile, int r_pitch, const void* ld,
                      const void* ls, const void* v, const void* g,
                      const void* lse, const void* delta, void* dls, void* dv,
                      int n_rows, int n_cols, int bm, int bn, int k, int d,
                      int nc, int v_bf16, float slope, int drop_on,
                      const void* seed, unsigned thresh, float drop_scale,
                      int row_block_off, int head_off, int col_block_off,
                      int n_paths, int t_pitch, const void* path_row_block,
                      void* stream) {
  return bwd_entry<false>(tiles, bcount, brow, btile, r_pitch, ld, ls, v, g,
                          lse, delta, nullptr, dls, dv, n_rows, n_cols, bm, bn,
                          k, d, nc, v_bf16, slope, drop_on, seed, thresh,
                          drop_scale, row_block_off, head_off, col_block_off,
                          n_paths, t_pitch, path_row_block, stream);
}

const char* han_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
