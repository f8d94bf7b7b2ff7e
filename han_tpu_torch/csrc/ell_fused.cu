// Fused ELL (fixed-fanout) attention forward for Hopper (sm_90a): neighbor
// gather + masked leaky-relu softmax over the F slots + coefficient dropout +
// weighted aggregation, one warp per destination row; and the backward of
// that forward on a tree block (tree_ell_bwd_kernel, below). Plain C
// interface, bound with ctypes by han_tpu_torch/ops/ell_fused.py (which
// also holds the plain PyTorch version of the forward and the general
// graph's plain torch backward) and han_tpu_torch/ops/tree_ell.py (the tree
// backward's plain version).
//
// The forward replaces han_tpu/ops/pallas/ell_fused.py:_kernel (l.54),
// launched there by _ell_fused_fwd_call (pallas_call at l.228). The tree
// backward replaces no TPU kernel: han_tpu's _tree_core (ops/tree_ell.py)
// is XLA gathers. It is added because on the card those gathers and the
// products over every padded slot of the block took about half of the
// device-sampled train step's device time; it shares the forward's
// helpers and row dealing, and like the forward it is bound by the
// latency of its dependent gathers (below).
//
// Math, per destination row i and head h (ld = logit_dst (N, K), ls =
// logit_src (N, K), fts = features (N, K*D), nbr (N, F) with sentinel >= N):
//   z_if   = leaky_relu(ld_ih + ls_{nbr[i,f] h})  on valid slots (nbr < N)
//   c_if   = softmax_f(z_if) over the valid slots; rows with none give 0
//   c'_if  = c_if * keep[i,f,h] / (1 - p)          (dropout after softmax)
//   out[i, h*D:(h+1)*D] = sum_f c'_if * fts[nbr[i,f], h*D:(h+1)*D]
// The keep mask is drawn outside the kernel (uint8 (N, F, K)) so that the
// plain version and the backward apply the same one.
//
// Features (and the output) are f32 or bf16 (the FT template argument, as
// han_tpu/ops/pallas/ell_fused.py:210-213,237 takes any feature dtype and
// returns it): bf16 rows are gathered as bf16, half the bytes, and widened
// to f32 in registers right after the load; the logits, the softmax and
// the sums stay f32, and the output is rounded to bf16 once, at the store.
//
// What bounds it on the H100, and what the design does about it:
// - At the sampled block of the 100M-edge configuration (8,704 rows, F =
//   16, K*D = 64 float32 channels) the data is small (the feature rows it
//   gathers sit in the 50 MB L2) and only the 512 seed rows of a one-hop
//   block have valid slots. The kernel is bound by the latency of its
//   dependent gathers (neighbor ids, then logits, then features) and by
//   how many of them are in flight, not by HBM bandwidth or arithmetic.
// - Rows are spread over the card: row r goes to block r % G and warp
//   r / G of it (G blocks of WARPS warps), so the seed rows, which come
//   first in a block, land in the first 512 blocks (one warp each) and the
//   block scheduler deals them to every SM. (With rows in order, 8 rows a
//   block, all the work sat in 64 blocks, on fewer than half the SMs.)
// - The slots are walked once, with every gather of a pass in flight
//   together. Logits: lanes own (slot, head) pairs (head h = lane % Kp for
//   Kp, the heads of a group of at most 32 rounded up to a power of two,
//   slots lane / Kp + s * 32 / Kp): each pair's logit is gathered and its
//   exp taken once, by one lane; the per-head max and sum are a lane-local
//   loop over the lane's slots and then log2(32 / Kp) xor shuffles. The
//   dropped numerators e * keep go to a per-warp shared buffer [F][K], the
//   neighbor ids to [F], the per-head scale (1 / (1-p)) / l to [K].
// - Aggregation: lanes own V-wide channel groups (V = 4, 2 or 1 channels,
//   as D and K*D allow: one 16-, 8- or 4-byte load a slot in f32, half of
//   that in bf16), with a runtime
//   loop over the groups, so any D and K*D are taken. The numerators are
//   read from shared memory (broadcast within a head), and the feature
//   loads of UNROLL slots are issued before their FMAs; a slot whose
//   numerator is 0 (empty or dropped) loads nothing.
// - exps are exp2 on log2e-scaled logits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;    // rows (warps) per block
constexpr int UNROLL = 8;   // slots whose feature loads are in flight together
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// V consecutive features at p, widened to f32 (one 4 V- or 2 V-byte load)
template <int V>
__device__ __forceinline__ void load_vec(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(float (&x)[V], const __nv_bfloat16* p) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
  } else if constexpr (V == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

// x * s into V consecutive outputs at p (bf16: rounded to nearest even)
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V], float s) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0] * s, x[1] * s, x[2] * s, x[3] * s);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0] * s, x[1] * s);
  else
    *p = x[0] * s;
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&x)[V], float s) {
  if constexpr (V == 4) {
    uint2 t;
    *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(x[0] * s, x[1] * s);
    *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(x[2] * s, x[3] * s);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0] * s, x[1] * s);
  } else {
    *p = __float2bfloat16_rn(x[0] * s);
  }
}

// floats of one warp's shared buffers: numerators [f][k], neighbor ids
// [f], per-head scales [k]
__host__ __device__ inline int warp_floats(int f, int k) { return f * k + f + k; }

template <int V, typename FT>
__global__ void __launch_bounds__(WARPS * 32) ell_fused_fwd_kernel(
    const int* __restrict__ nbr, const float* __restrict__ ld,
    const float* __restrict__ ls, const FT* __restrict__ fts,
    const uint8_t* __restrict__ keep, FT* __restrict__ out, int n, int f,
    int k, int d, float slope, float drop_scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp * gridDim.x + blockIdx.x;
  if (row >= n) return;  // warp-uniform
  const int kd = k * d;
  float* e_s = smem + (size_t)warp * warp_floats(f, k);
  int* j_s = reinterpret_cast<int*>(e_s + f * k);
  float* inv_s = reinterpret_cast<float*>(j_s + f);
  const int* nbr_r = nbr + (size_t)row * f;
  FT* out_r = out + (size_t)row * kd;

  // logits and softmax, one group of up to 32 heads at a time
  for (int h0 = 0; h0 < k; h0 += 32) {
    const int kg = min(32, k - h0);
    const int kp = kg == 1 ? 1 : 1 << (32 - __clz(kg - 1));  // power of two >= kg
    const int sp = 32 / kp;  // slots a pass
    const int hl = lane & (kp - 1), sub = lane / kp;
    const bool hv = hl < kg;
    const int h = h0 + hl;
    const float ldh = hv ? ld[(size_t)row * k + h] : 0.f;
    float m = -INFINITY;
    bool any = false;
#pragma unroll 4
    for (int s = sub; s < f; s += sp) {
      const int j = nbr_r[s];
      const bool valid = j >= 0 && j < n;
      float z = -INFINITY;
      if (hv && valid) {
        const float raw = ldh + ls[(size_t)j * k + h];
        z = fmaxf(raw, slope * raw) * LOG2E;
      }
      if (hv) e_s[s * k + h] = z;
      if (h0 == 0 && hl == 0) j_s[s] = valid ? j : -1;
      m = fmaxf(m, z);
      any |= valid;
    }
    if (h0 == 0 && !__any_sync(FULL_MASK, any)) {
      // no valid slot: the softmax is empty, the output exactly 0
      const float zero[1] = {0.f};
      for (int c = lane; c < kd; c += 32) store_vec<1>(out_r + c, zero, 0.f);
      return;
    }
    for (int o = kp; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
    // the exps, once a pair (-inf on empty slots gives 0): the undropped
    // sum l, the dropped numerators into the buffer
    float l = 0.f;
    if (hv) {
#pragma unroll 4
      for (int s = sub; s < f; s += sp) {
        const float e = ex2(e_s[s * k + h] - m);
        l += e;
        const bool kept = keep == nullptr || keep[((size_t)row * f + s) * k + h];
        e_s[s * k + h] = kept ? e : 0.f;
      }
    }
    for (int o = kp; o < 32; o <<= 1) l += __shfl_xor_sync(FULL_MASK, l, o);
    if (hv && sub == 0) inv_s[h] = drop_scale / fmaxf(l, 1e-30f);
  }
  __syncwarp();

  // the weighted sum: lane groups of V channels, UNROLL slots' loads in
  // flight before their FMAs
  for (int q = lane; q < kd / V; q += 32) {
    const int c0 = q * V;
    const float* e_h = e_s + c0 / d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int s0 = 0; s0 < f; s0 += UNROLL) {
      float w[UNROLL], x[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = s0 + u;
        const int j = s < f ? j_s[s] : -1;
        w[u] = j >= 0 ? e_h[s * k] : 0.f;
        if (w[u] != 0.f) {
          load_vec<V>(x[u], fts + (size_t)j * kd + c0);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[u][v] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(w[u], x[u][v], acc[v]);
    }
    store_vec<V>(out_r + c0, acc, inv_s[c0 / d]);
  }
}

template <int V, typename FT>
int launch(const void* nbr, const void* ld, const void* ls, const void* fts,
           const void* keep, void* out, int n, int f, int k, int d, float slope,
           float drop_scale, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * warp_floats(f, k) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_fused_fwd_kernel<V, FT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check reports it
      return (int)err;
    }
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  ell_fused_fwd_kernel<V, FT><<<blocks, WARPS * 32, smem, stream>>>(
      (const int*)nbr, (const float*)ld, (const float*)ls, (const FT*)fts,
      (const uint8_t*)keep, (FT*)out, n, f, k, d, slope, drop_scale);
  return (int)cudaGetLastError();
}

// floats of one warp's shared buffers in the tree backward: exps (then
// c~) [f][k], g.v [f][k], leaky_relu' [f][k], neighbor ids [f]
__host__ __device__ inline int bwd_warp_floats(int f, int k) { return 3 * f * k + f; }

// The backward of the forward above on a TREE block (every row is held by
// at most one valid slot of nbr, and parent_row / parent_slot name it:
// graph/containers.TreeEllGraph), parent by parent: one warp a row, dealt
// as the forward deals them. The warp recomputes its row's softmax as the
// forward does (the same logits, max, ex2 and sum), then, per valid slot f
// and head h, gv_f = g_i[h,:] . v_nbr[f][h,:] (a lane a (slot, head)
// pair, as the logits), dz_f = c_f (mk_f gv_f - sum_f' c~_f' gv_f') times
// leaky_relu' at the raw logit, with c~ = c mk and mk = keep / (1 - p).
// It writes dld[i, h] = sum_f dz_f and, to each valid child j = nbr[i, f],
// dls[j, h] = dz_f and dv[j, h*D:(h+1)*D] = c~_f g_i[h,:]. A row no valid
// slot holds (a root, a pad, a child of an empty slot) zeroes its own dv
// and dls rows. Each output row is written by one warp: no atomics, and
// the result does not depend on the order the warps run in.
template <int V, typename FT>
__global__ void __launch_bounds__(WARPS * 32) tree_ell_bwd_kernel(
    const int* __restrict__ nbr, const int* __restrict__ parent_row,
    const int* __restrict__ parent_slot, const float* __restrict__ ld,
    const float* __restrict__ ls, const FT* __restrict__ fts,
    const uint8_t* __restrict__ keep, const FT* __restrict__ g,
    FT* __restrict__ dv, float* __restrict__ dld, float* __restrict__ dls, int n,
    int f, int k, int d, float slope, float drop_scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp * gridDim.x + blockIdx.x;
  if (row >= n) return;  // warp-uniform
  const int kd = k * d;
  float* e_s = smem + (size_t)warp * bwd_warp_floats(f, k);
  float* gv_s = e_s + f * k;
  float* lk_s = gv_s + f * k;
  int* j_s = reinterpret_cast<int*>(lk_s + f * k);
  const int* nbr_r = nbr + (size_t)row * f;
  const FT* g_r = g + (size_t)row * kd;

  // this row's own dv and dls are 0 unless its parent's valid slot holds it
  const int pr = parent_row[row];
  if (pr < 0 || pr >= n || nbr[(size_t)pr * f + parent_slot[row]] != row) {
    const float zero[1] = {0.f};
    for (int c = lane; c < kd; c += 32) store_vec<1>(dv + (size_t)row * kd + c, zero, 0.f);
    for (int h = lane; h < k; h += 32) dls[(size_t)row * k + h] = 0.f;
  }

  for (int h0 = 0; h0 < k; h0 += 32) {
    const int kg = min(32, k - h0);
    const int kp = kg == 1 ? 1 : 1 << (32 - __clz(kg - 1));  // power of two >= kg
    const int sp = 32 / kp;  // slots a pass
    const int hl = lane & (kp - 1), sub = lane / kp;
    const bool hv = hl < kg;
    const int h = h0 + hl;
    // the forward's logits and softmax
    const float ldh = hv ? ld[(size_t)row * k + h] : 0.f;
    float m = -INFINITY;
    bool any = false;
#pragma unroll 4
    for (int s = sub; s < f; s += sp) {
      const int j = nbr_r[s];
      const bool valid = j >= 0 && j < n;
      float z = -INFINITY, lk = 0.f;
      if (hv && valid) {
        const float raw = ldh + ls[(size_t)j * k + h];
        z = fmaxf(raw, slope * raw) * LOG2E;
        lk = raw >= 0.f ? 1.f : slope;
      }
      if (hv) {
        e_s[s * k + h] = z;
        lk_s[s * k + h] = lk;
      }
      if (h0 == 0 && hl == 0) j_s[s] = valid ? j : -1;
      m = fmaxf(m, z);
      any |= valid;
    }
    if (h0 == 0 && !__any_sync(FULL_MASK, any)) {
      // no valid slot: dz is empty, dld exactly 0, no child to write
      for (int hh = lane; hh < k; hh += 32) dld[(size_t)row * k + hh] = 0.f;
      return;
    }
    for (int o = kp; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
    float l = 0.f;
    if (hv) {
#pragma unroll 4
      for (int s = sub; s < f; s += sp) {
        const float e = ex2(e_s[s * k + h] - m);
        l += e;
        e_s[s * k + h] = e;
      }
    }
    for (int o = kp; o < 32; o <<= 1) l += __shfl_xor_sync(FULL_MASK, l, o);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __syncwarp();  // j_s of every slot

    // gv over the valid slots, and t = sum_f c~_f gv_f
    float t = 0.f;
    if (hv) {
      const FT* g_h = g_r + (size_t)h * d;
#pragma unroll 4
      for (int s = sub; s < f; s += sp) {
        const int j = j_s[s];
        float gv = 0.f;
        if (j >= 0) {
          const FT* v_h = fts + (size_t)j * kd + (size_t)h * d;
          for (int c = 0; c < d; c += V) {
            float x[V], y[V];
            load_vec<V>(x, v_h + c);
            load_vec<V>(y, g_h + c);
#pragma unroll
            for (int u = 0; u < V; ++u) gv = fmaf(x[u], y[u], gv);
          }
        }
        gv_s[s * k + h] = gv;
        const bool kept = keep == nullptr || keep[((size_t)row * f + s) * k + h];
        t = fmaf(e_s[s * k + h] * inv * (kept ? drop_scale : 0.f), gv, t);
      }
    }
    for (int o = kp; o < 32; o <<= 1) t += __shfl_xor_sync(FULL_MASK, t, o);

    // dz: dls of each valid child, dld as the row sum; c~ into e_s for dv
    float sdz = 0.f;
    if (hv) {
#pragma unroll 4
      for (int s = sub; s < f; s += sp) {
        const int j = j_s[s];
        const bool kept = keep == nullptr || keep[((size_t)row * f + s) * k + h];
        const float mk = kept ? drop_scale : 0.f;
        const float c = e_s[s * k + h] * inv;
        if (j >= 0) {
          const float dz = c * (mk * gv_s[s * k + h] - t) * lk_s[s * k + h];
          dls[(size_t)j * k + h] = dz;
          sdz += dz;
        }
        e_s[s * k + h] = c * mk;
      }
    }
    for (int o = kp; o < 32; o <<= 1) sdz += __shfl_xor_sync(FULL_MASK, sdz, o);
    if (hv && sub == 0) dld[(size_t)row * k + h] = sdz;
  }
  __syncwarp();  // c~ of every (slot, head)

  // dv of each valid child: c~ times the row's g, lane groups of V channels
  for (int q = lane; q < kd / V; q += 32) {
    const int c0 = q * V;
    const float* ct = e_s + c0 / d;
    float y[V];
    load_vec<V>(y, g_r + c0);
    for (int s = 0; s < f; ++s) {
      const int j = j_s[s];
      if (j >= 0) store_vec<V>(dv + (size_t)j * kd + c0, y, ct[s * k]);
    }
  }
}

template <int V, typename FT>
int launch_bwd(const void* nbr, const void* parent_row, const void* parent_slot,
               const void* ld, const void* ls, const void* fts, const void* keep,
               const void* g, void* dv, void* dld, void* dls, int n, int f, int k, int d,
               float slope, float drop_scale, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * bwd_warp_floats(f, k) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_ell_bwd_kernel<V, FT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check reports it
      return (int)err;
    }
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  tree_ell_bwd_kernel<V, FT><<<blocks, WARPS * 32, smem, stream>>>(
      (const int*)nbr, (const int*)parent_row, (const int*)parent_slot, (const float*)ld,
      (const float*)ls, (const FT*)fts, (const uint8_t*)keep, (const FT*)g, (FT*)dv,
      (float*)dld, (float*)dls, n, f, k, d, slope, drop_scale);
  return (int)cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};

// V channels a lane (the forward's rule): V elements of every feature-
// shaped pointer in `at` must be one aligned load or store
inline int vec_width(int k, int d, uintptr_t at, size_t es) {
  const int kd = k * d;
  return d % 4 == 0 && kd >= 128 && at % (4 * es) == 0   ? 4
         : d % 2 == 0 && kd >= 64 && at % (2 * es) == 0 ? 2
                                                         : 1;
}

}  // namespace

extern "C" {

// Forward. nbr int32 [n, f] (sentinel n; any id outside [0, n) is an empty
// slot); ld, ls f32 [n, k]; fts f32, or bf16 when fts_bf16, [n, k*d]; keep
// uint8 [n, f, k], or null when dropout is off; drop_scale = 1 / (1 - p) (1
// when off) -> out [n, k*d] in fts's type. Any f, k, d >= 1 whose per-warp
// buffers (warp_floats) fit a block's shared memory; past that the launch
// returns cudaErrorInvalidValue. Returns a cudaError_t code (0 = launched).
int han_ell_fused_fwd(const void* nbr, const void* ld, const void* ls,
                      const void* fts, const void* keep, void* out, int n,
                      int f, int k, int d, int fts_bf16, float slope,
                      float drop_scale, void* stream) {
  if (n < 0 || f <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  // fts and out share their row pitch and base alignment
  const int v = vec_width(k, d, (uintptr_t)fts | (uintptr_t)out, fts_bf16 ? 2 : 4);
  auto go = [&](auto tag) {
    using FT = typename decltype(tag)::type;
    if (v == 4) return launch<4, FT>(nbr, ld, ls, fts, keep, out, n, f, k, d, slope, drop_scale, st);
    if (v == 2) return launch<2, FT>(nbr, ld, ls, fts, keep, out, n, f, k, d, slope, drop_scale, st);
    return launch<1, FT>(nbr, ld, ls, fts, keep, out, n, f, k, d, slope, drop_scale, st);
  };
  return fts_bf16 ? go(Type<__nv_bfloat16>{}) : go(Type<float>{});
}

// Tree backward (tree_ell_bwd_kernel): the forward's arguments, the
// parent maps parent_row, parent_slot int32 [n] (parent_row >= n or < 0:
// no parent) and g [n, k*d] in fts's type -> dv [n, k*d] in fts's type,
// dld, dls f32 [n, k], every element written. nbr must be a tree whose
// every valid slot (r, f) holds a row j with parent_row[j] = r and
// parent_slot[j] = f. Returns a cudaError_t code (0 = launched).
int han_tree_ell_bwd(const void* nbr, const void* parent_row, const void* parent_slot,
                     const void* ld, const void* ls, const void* fts, const void* keep,
                     const void* g, void* dv, void* dld, void* dls, int n, int f, int k,
                     int d, int fts_bf16, float slope, float drop_scale, void* stream) {
  if (n < 0 || f <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int v = vec_width(k, d, (uintptr_t)fts | (uintptr_t)g | (uintptr_t)dv,
                          fts_bf16 ? 2 : 4);
  auto go = [&](auto tag) {
    using FT = typename decltype(tag)::type;
    if (v == 4)
      return launch_bwd<4, FT>(nbr, parent_row, parent_slot, ld, ls, fts, keep, g, dv, dld,
                               dls, n, f, k, d, slope, drop_scale, st);
    if (v == 2)
      return launch_bwd<2, FT>(nbr, parent_row, parent_slot, ld, ls, fts, keep, g, dv, dld,
                               dls, n, f, k, d, slope, drop_scale, st);
    return launch_bwd<1, FT>(nbr, parent_row, parent_slot, ld, ls, fts, keep, g, dv, dld,
                             dls, n, f, k, d, slope, drop_scale, st);
  };
  return fts_bf16 ? go(Type<__nv_bfloat16>{}) : go(Type<float>{});
}

const char* han_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
