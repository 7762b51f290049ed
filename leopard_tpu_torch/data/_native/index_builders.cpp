// Native dataset index builders for leopard-tpu.
//
// Role parity with the reference's pybind11 helpers
// (Megatron-LM-240603/megatron/core/datasets/helpers.cpp): O(n) index
// construction that is too slow in Python — dataset blending, GPT-style
// sample packing, epoch shuffles — plus a first-fit-decreasing sequence
// packer used by the multi-image SFT pipeline to cut padding waste.
//
// Exposed through a plain C ABI and loaded with ctypes (no pybind11 in the
// image); all buffers are caller-allocated numpy arrays.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Greedy max-error blending: emit, for each output sample, which dataset it
// comes from and the running per-dataset sample count, so the realized mix
// tracks `weights` as closely as possible at every prefix.
void leopard_build_blending_indices(int16_t *dataset_index,
                                    int64_t *dataset_sample_index,
                                    const double *weights,
                                    int32_t num_datasets,
                                    int64_t size) {
  std::vector<int64_t> counts(num_datasets, 0);
  for (int64_t s = 0; s < size; ++s) {
    double denom = s > 1 ? static_cast<double>(s) : 1.0;
    int32_t best = 0;
    double best_err = -std::numeric_limits<double>::infinity();
    for (int32_t d = 0; d < num_datasets; ++d) {
      double err = weights[d] * denom - static_cast<double>(counts[d]);
      if (err > best_err) {
        best_err = err;
        best = d;
      }
    }
    dataset_index[s] = static_cast<int16_t>(best);
    dataset_sample_index[s] = counts[best];
    counts[best] += 1;
  }
}

// Exact-count blending: draw exactly sizes[d] samples from dataset d, in an
// order that keeps the realized prefix mix proportional to sizes.
void leopard_build_exhaustive_blending_indices(int16_t *dataset_index,
                                               int64_t *dataset_sample_index,
                                               const int64_t *sizes,
                                               int32_t num_datasets) {
  int64_t total = 0;
  for (int32_t d = 0; d < num_datasets; ++d) total += sizes[d];
  std::vector<double> weights(num_datasets);
  for (int32_t d = 0; d < num_datasets; ++d)
    weights[d] = static_cast<double>(sizes[d]) / static_cast<double>(total);

  std::vector<int64_t> counts(num_datasets, 0);
  std::vector<char> live(num_datasets, 1);
  int32_t n_live = num_datasets;
  for (int64_t s = 0; s < total && n_live > 0; ++s) {
    double denom = s > 1 ? static_cast<double>(s) : 1.0;
    int32_t best = -1;
    double best_err = -std::numeric_limits<double>::infinity();
    for (int32_t d = 0; d < num_datasets; ++d) {
      if (!live[d]) continue;
      double err = weights[d] * denom - static_cast<double>(counts[d]);
      if (err > best_err) {
        best_err = err;
        best = d;
      }
    }
    dataset_index[s] = static_cast<int16_t>(best);
    dataset_sample_index[s] = counts[best];
    counts[best] += 1;
    if (counts[best] >= sizes[best]) {
      live[best] = 0;
      n_live -= 1;
    }
  }
}

// GPT-style sample index: pack shuffled documents into contiguous
// (seq_len + 1)-token training samples. Output rows are (position in
// document_order, offset within that document) for each sample boundary;
// rows = num_samples + 1.
//
// document_lengths: length (tokens) per document id.
// document_order:   epoch-expanded, shuffled document ids.
int64_t leopard_build_sample_index(const int32_t *document_lengths,
                                   const int32_t *document_order,
                                   int64_t num_order,
                                   int32_t seq_len,
                                   int64_t num_samples,
                                   int64_t *out_rows /* (num_samples+1) x 2 */) {
  int64_t sample = 0;
  int64_t doc_pos = 0;
  int32_t doc_off = 0;
  out_rows[0] = doc_pos;
  out_rows[1] = doc_off;
  while (sample < num_samples && doc_pos < num_order) {
    int64_t remaining = seq_len + 1;  // +1: targets are inputs shifted by one
    while (remaining > 0 && doc_pos < num_order) {
      int32_t doc_len = document_lengths[document_order[doc_pos]] - doc_off;
      if (doc_len > remaining) {
        doc_off += static_cast<int32_t>(remaining);
        remaining = 0;
      } else {
        remaining -= doc_len;
        doc_pos += 1;
        doc_off = 0;
      }
    }
    sample += 1;
    out_rows[2 * sample] = doc_pos;
    out_rows[2 * sample + 1] = doc_off;
  }
  return sample;  // samples actually built (== num_samples unless data ran out)
}

// splitmix64 — deterministic, seedable PRNG for shuffles.
static inline uint64_t splitmix64(uint64_t *state) {
  uint64_t z = (*state += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// In-place Fisher-Yates over an int64 index array.
void leopard_shuffle_indices(int64_t *indices, int64_t n, uint64_t seed) {
  uint64_t state = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(&state) % (i + 1));
    std::swap(indices[i], indices[j]);
  }
}

// First-fit-decreasing sequence packing: assign each variable-length sample
// to a bin of capacity `cap`, minimizing bins (≈ padding waste). Samples
// longer than cap get bin_ids[i] = -1 (caller skips them — the reference
// instead drops over-long samples at mm_pretrain_dataset.py:333).
// Returns the number of bins used.
int64_t leopard_pack_sequences_ffd(const int32_t *lengths, int64_t n,
                                   int32_t cap, int32_t *bin_ids) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return lengths[a] > lengths[b];
  });
  std::vector<int32_t> space;  // remaining capacity per bin
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = order[k];
    if (lengths[i] > cap) {
      bin_ids[i] = -1;
      continue;
    }
    int32_t placed = -1;
    for (size_t b = 0; b < space.size(); ++b) {
      if (space[b] >= lengths[i]) {
        placed = static_cast<int32_t>(b);
        break;
      }
    }
    if (placed < 0) {
      space.push_back(cap);
      placed = static_cast<int32_t>(space.size()) - 1;
    }
    space[placed] -= lengths[i];
    bin_ids[i] = placed;
  }
  return static_cast<int64_t>(space.size());
}

}  // extern "C"
