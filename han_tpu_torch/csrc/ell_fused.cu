// Fused ELL (fixed-fanout) attention forward for Hopper (sm_90a): neighbor
// gather + masked leaky-relu softmax over the F slots + coefficient dropout +
// weighted aggregation, one warp per destination row. Plain C interface,
// bound with ctypes by han_tpu_torch/ops/ell_fused.py, which also holds the
// plain PyTorch version of the kernel and the (plain torch) backward.
//
// Replaces han_tpu/ops/pallas/ell_fused.py:_kernel (l.54), launched there by
// _ell_fused_fwd_call (pallas_call at l.228).
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
// What bounds it on the H100, and what the design does about it:
// - At the sampled block of the 100M-edge configuration (8,704 rows, F =
//   16, K*D = 64 float32 channels) the gathers total about 40 MB, but they
//   hit a 2.2 MB feature table that the 50 MB L2 holds. The kernel is bound
//   by gather latency and issue rate, not by HBM bandwidth. Most rows of a
//   one-hop block have no valid slot at all and exit after the index load.
// - One warp per row: lane l owns the channels l + 32 t (t < MAXC), so the
//   K*D-wide feature row of a neighbor (256 bytes at K*D = 64) is one
//   coalesced load per t, and the 32 lanes share the row's index loads.
//   The F neighbor ids are loaded 32 at a time, one per lane, and broadcast
//   with __shfl_sync, so F (16 on the trained blocks, ~100 in exact eval)
//   is a runtime argument with no shared memory.
// - Two passes over F: the first takes the per-head max of z, the second
//   sums exp(z - max) and the dropped-and-weighted features. That keeps
//   the arithmetic of the plain version (max first, no rescaling) at the
//   price of gathering ls twice, which L2 serves.
// - D is a template argument (4, 8 or 16, as in flash_gat.cu), so the head
//   of a channel is a shift; K is a runtime argument with K*D <= 32*MAXC.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // rows (warps) per block
constexpr int MAXC = 4;    // channels per lane: K*D <= 32 * MAXC
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int D>
__global__ void __launch_bounds__(WARPS * 32) ell_fused_fwd_kernel(
    const int* __restrict__ nbr, const float* __restrict__ ld,
    const float* __restrict__ ls, const float* __restrict__ fts,
    const uint8_t* __restrict__ keep, float* __restrict__ out, int n, int f,
    int k, float slope, float drop_scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform
  const int kd = k * D;
  const int* nbr_r = nbr + (size_t)row * f;
  const uint8_t* keep_r = keep ? keep + (size_t)row * f * k : nullptr;

  int head[MAXC];
  float ld_c[MAXC], m[MAXC], l[MAXC], acc[MAXC];
#pragma unroll
  for (int t = 0; t < MAXC; ++t) {
    const int c = lane + 32 * t;
    head[t] = c < kd ? c / D : 0;
    ld_c[t] = c < kd ? ld[(size_t)row * k + head[t]] : 0.f;
    m[t] = -INFINITY;
    l[t] = 0.f;
    acc[t] = 0.f;
  }

  // pass 1: the per-head max of z over the valid slots
  bool any = false;
  for (int f0 = 0; f0 < f; f0 += 32) {
    const int j_lane = f0 + lane < f ? nbr_r[f0 + lane] : n;
    const int cnt = min(32, f - f0);
    for (int s = 0; s < cnt; ++s) {
      const int j = __shfl_sync(FULL_MASK, j_lane, s);
      if (j < 0 || j >= n) continue;  // warp-uniform
      any = true;
      const float* ls_j = ls + (size_t)j * k;
#pragma unroll
      for (int t = 0; t < MAXC; ++t) {
        if (lane + 32 * t < kd) {
          const float raw = ld_c[t] + ls_j[head[t]];
          m[t] = fmaxf(m[t], fmaxf(raw, slope * raw));
        }
      }
    }
  }
  float* out_r = out + (size_t)row * kd;
  if (!any) {  // no valid slot: the softmax is empty, the output exactly 0
#pragma unroll
    for (int t = 0; t < MAXC; ++t)
      if (lane + 32 * t < kd) out_r[lane + 32 * t] = 0.f;
    return;
  }

  // pass 2: softmax numerators (undropped) and the dropped weighted sum
  for (int f0 = 0; f0 < f; f0 += 32) {
    const int j_lane = f0 + lane < f ? nbr_r[f0 + lane] : n;
    const int cnt = min(32, f - f0);
    for (int s = 0; s < cnt; ++s) {
      const int j = __shfl_sync(FULL_MASK, j_lane, s);
      if (j < 0 || j >= n) continue;  // warp-uniform
      const float* ls_j = ls + (size_t)j * k;
      const float* fts_j = fts + (size_t)j * kd;
      const uint8_t* keep_f = keep_r ? keep_r + (size_t)(f0 + s) * k : nullptr;
#pragma unroll
      for (int t = 0; t < MAXC; ++t) {
        const int c = lane + 32 * t;
        if (c < kd) {
          const float raw = ld_c[t] + ls_j[head[t]];
          const float e = expf(fmaxf(raw, slope * raw) - m[t]);
          l[t] += e;
          if (!keep_f || keep_f[head[t]]) acc[t] = fmaf(e, fts_j[c], acc[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MAXC; ++t) {
    const int c = lane + 32 * t;
    if (c < kd) out_r[c] = acc[t] * (drop_scale / fmaxf(l[t], 1e-30f));
  }
}

template <int D>
int launch(const void* nbr, const void* ld, const void* ls, const void* fts,
           const void* keep, void* out, int n, int f, int k, float slope,
           float drop_scale, cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  ell_fused_fwd_kernel<D><<<blocks, WARPS * 32, 0, stream>>>(
      (const int*)nbr, (const float*)ld, (const float*)ls, (const float*)fts,
      (const uint8_t*)keep, (float*)out, n, f, k, slope, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward. nbr int32 [n, f] (sentinel n; any id outside [0, n) is an empty
// slot); ld, ls f32 [n, k]; fts f32 [n, k*d]; keep uint8 [n, f, k], or null
// when dropout is off; drop_scale = 1 / (1 - p) (1 when off) -> out f32
// [n, k*d]. Returns a cudaError_t code (0 = launched).
int han_ell_fused_fwd(const void* nbr, const void* ld, const void* ls,
                      const void* fts, const void* keep, void* out, int n,
                      int f, int k, int d, float slope, float drop_scale,
                      void* stream) {
  if (n < 0 || f <= 0 || k <= 0 || k * d > 32 * MAXC)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 4: return launch<4>(nbr, ld, ls, fts, keep, out, n, f, k, slope, drop_scale, st);
    case 8: return launch<8>(nbr, ld, ls, fts, keep, out, n, f, k, slope, drop_scale, st);
    case 16: return launch<16>(nbr, ld, ls, fts, keep, out, n, f, k, slope, drop_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* han_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
