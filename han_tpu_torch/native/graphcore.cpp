// graphcore — native host-side graph runtime for han_tpu.
//
// The reference delegates all graph preprocessing to scipy/networkx in
// Python (utils/process.py, utils/process_ppi.py); at the scale this
// framework targets (BASELINE.json: synthetic 100M-edge graphs) those are
// the host bottleneck. This library provides the hot host paths in C++:
//
//   - COO → CSR construction (counting sort)
//   - binary SpGEMM (meta-path composition A·B over unweighted graphs)
//   - per-row uniform neighbor sampling without replacement (ELL output)
//   - connected components (iterative BFS; replaces the reference's
//     recursive DFS with recursionlimit=99999, process_ppi.py:8-32)
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" {

// COO (rows, cols; nnz entries, may be unsorted, may contain duplicates)
// → CSR. Returns deduplicated nnz. out_col_idx must have capacity nnz.
int64_t csr_from_coo(int64_t n, int64_t nnz, const int32_t* rows,
                     const int32_t* cols, int64_t* out_row_ptr,
                     int32_t* out_col_idx) {
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) cnt[rows[e] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::vector<int32_t> tmp(nnz);
  {
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < nnz; ++e) tmp[cur[rows[e]]++] = cols[e];
  }
  // sort + dedup each row
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = cnt[i], e = cnt[i + 1];
    std::sort(tmp.begin() + b, tmp.begin() + e);
    out_row_ptr[i] = w;
    int32_t prev = -1;
    for (int64_t k = b; k < e; ++k) {
      if (tmp[k] != prev) {
        out_col_idx[w++] = tmp[k];
        prev = tmp[k];
      }
    }
  }
  out_row_ptr[n] = w;
  return w;
}

// Binary SpGEMM: C = binarize(A · B), A is (n×m) CSR, B is (m×p) CSR.
// Two-phase with a dense marker per row. Pass out_col_idx == nullptr to get
// the required nnz (phase 1), then call again with allocated buffers.
int64_t spgemm_binary(int64_t n, int64_t p, const int64_t* a_row_ptr,
                      const int32_t* a_col_idx, const int64_t* b_row_ptr,
                      const int32_t* b_col_idx, int64_t* out_row_ptr,
                      int32_t* out_col_idx) {
  std::vector<int64_t> marker(p, -1);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (out_col_idx) out_row_ptr[i] = total;
    int64_t row_start = total;
    for (int64_t ak = a_row_ptr[i]; ak < a_row_ptr[i + 1]; ++ak) {
      int32_t k = a_col_idx[ak];
      for (int64_t bk = b_row_ptr[k]; bk < b_row_ptr[k + 1]; ++bk) {
        int32_t j = b_col_idx[bk];
        if (marker[j] < row_start) {
          marker[j] = total;
          if (out_col_idx) out_col_idx[total] = j;
          ++total;
        }
      }
    }
    if (out_col_idx)
      std::sort(out_col_idx + row_start, out_col_idx + total);
  }
  if (out_col_idx) out_row_ptr[n] = total;
  return total;
}

// Uniform neighbor sampling without replacement: CSR → ELL (n × fanout),
// padding with the sentinel value `n`. Deterministic in `seed`.
void sample_neighbors(int64_t n, const int64_t* row_ptr,
                      const int32_t* col_idx, int64_t fanout, uint64_t seed,
                      int32_t* out_nbr /* n*fanout */) {
  std::mt19937_64 rng(seed);
  std::vector<int32_t> buf;
  for (int64_t i = 0; i < n; ++i) {
    int64_t deg = row_ptr[i + 1] - row_ptr[i];
    int32_t* out = out_nbr + i * fanout;
    if (deg <= fanout) {
      int64_t k = 0;
      for (; k < deg; ++k) out[k] = col_idx[row_ptr[i] + k];
      for (; k < fanout; ++k) out[k] = (int32_t)n;
    } else {
      // partial Fisher–Yates over a copy of the neighbor list
      buf.assign(col_idx + row_ptr[i], col_idx + row_ptr[i + 1]);
      for (int64_t k = 0; k < fanout; ++k) {
        std::uniform_int_distribution<int64_t> d(k, deg - 1);
        std::swap(buf[k], buf[d(rng)]);
        out[k] = buf[k];
      }
      std::sort(out, out + fanout);
    }
  }
}

// L-hop bounded-fanout block sampling around a seed batch (the mini-batch
// training workload, train/sampled.py). Emits the SubgraphBatch layout:
//   out_nodes: int32[block_size] global ids, -1 pad, seeds first;
//   out_nbr:   int32[block_size * fanout] LOCAL neighbor positions,
//              pad = block_size.
// Returns the number of real nodes in the block. Deterministic in `seed`.
int64_t sample_block(int64_t n, const int64_t* row_ptr,
                     const int32_t* col_idx, int64_t n_seeds,
                     const int32_t* seeds, int64_t fanout, int64_t hops,
                     int64_t block_size, uint64_t seed, int32_t* out_nodes,
                     int32_t* out_nbr) {
  std::mt19937_64 rng(seed);
  std::unordered_map<int32_t, int32_t> position;
  position.reserve((size_t)block_size * 2);
  std::vector<int32_t> order;
  order.reserve(block_size);
  for (int64_t s = 0; s < n_seeds && s < block_size; ++s) {
    position.emplace(seeds[s], (int32_t)order.size());
    order.push_back(seeds[s]);
  }
  std::fill(out_nbr, out_nbr + block_size * fanout, (int32_t)block_size);
  std::vector<int32_t> frontier(order), nxt, buf;
  std::vector<uint8_t> has_sample(block_size, 0);
  for (int64_t hop = 0; hop < hops; ++hop) {
    nxt.clear();
    for (int32_t u : frontier) {
      int32_t row = position[u];
      if (has_sample[row]) continue;
      has_sample[row] = 1;
      int64_t lo = row_ptr[u], deg = row_ptr[u + 1] - lo;
      buf.assign(col_idx + lo, col_idx + lo + deg);
      int64_t take = deg;
      if (deg > fanout) {  // partial Fisher–Yates, then sort for determinism
        for (int64_t k = 0; k < fanout; ++k) {
          std::uniform_int_distribution<int64_t> d(k, deg - 1);
          std::swap(buf[k], buf[d(rng)]);
        }
        take = fanout;
        std::sort(buf.begin(), buf.begin() + take);
      }
      int32_t* out = out_nbr + (int64_t)row * fanout;
      int64_t w = 0;
      for (int64_t k = 0; k < take; ++k) {
        int32_t v = buf[k];
        auto it = position.find(v);
        if (it == position.end()) {
          if ((int64_t)order.size() >= block_size) continue;  // cap hit
          it = position.emplace(v, (int32_t)order.size()).first;
          order.push_back(v);
          nxt.push_back(v);
        }
        out[w++] = it->second;
      }
    }
    frontier.swap(nxt);
    if ((int64_t)order.size() >= block_size && frontier.empty()) break;
  }
  int64_t n_real = (int64_t)order.size();
  for (int64_t i = 0; i < n_real; ++i) out_nodes[i] = order[i];
  for (int64_t i = n_real; i < block_size; ++i) out_nodes[i] = -1;
  return n_real;
}

// Connected components over an undirected CSR graph; writes component id
// per node, returns the number of components.
int64_t connected_components(int64_t n, const int64_t* row_ptr,
                             const int32_t* col_idx, int64_t* out_comp) {
  std::fill(out_comp, out_comp + n, -1);
  std::vector<int64_t> stack;
  int64_t cur = 0;
  for (int64_t s = 0; s < n; ++s) {
    if (out_comp[s] >= 0) continue;
    stack.push_back(s);
    out_comp[s] = cur;
    while (!stack.empty()) {
      int64_t u = stack.back();
      stack.pop_back();
      for (int64_t k = row_ptr[u]; k < row_ptr[u + 1]; ++k) {
        int32_t v = col_idx[k];
        if (out_comp[v] < 0) {
          out_comp[v] = cur;
          stack.push_back(v);
        }
      }
    }
    ++cur;
  }
  return cur;
}

}  // extern "C"
