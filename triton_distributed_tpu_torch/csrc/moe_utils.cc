// MoE token-sort / block-align host routine of the PyTorch port.
//
// A port copy of the repository's csrc/moe_utils.cc (`AlignBlockSize`
// :33 and its `extern "C"` host entry :48-60), without the XLA FFI handler:
// the port reaches it through ctypes (triton_distributed_tpu_torch/
// native.py) and wraps it as a torch custom op
// (ops/moe/native_sort.py). It sorts flattened top-k token->expert
// assignments into expert-contiguous order, padding each expert's segment
// to a multiple of the grouped-GEMM block size, and emits the per-block
// expert map. Host code: it runs on the CPU, in planning, and no GPU
// kernel is involved.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// sorted_ids[cap]: slot -> source index into the flattened [T*k] routing
//   (sentinel n for pad slots). Each expert segment is padded to a
//   multiple of block_size.
// block_expert[bcap]: grouped-GEMM tile -> expert id (-1 past the end).
// counts[2]: {num_blocks, num_padded_slots}.
// Returns 0, or 1 (bad num_experts / block_size), 2 (an expert id out of
// range), 3 (the outputs too small).
int AlignBlockSize(const int32_t* eids, int64_t n, int32_t num_experts,
                   int32_t block_size, int32_t* sorted_ids, int64_t cap,
                   int32_t* block_expert, int64_t bcap, int32_t* counts) {
  if (block_size <= 0 || num_experts <= 0) return 1;
  std::vector<int64_t> count(num_experts, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t e = eids[i];
    if (e < 0 || e >= num_experts) return 2;
    ++count[e];
  }
  std::vector<int64_t> padded(num_experts), start(num_experts);
  int64_t total_padded = 0;
  for (int32_t e = 0; e < num_experts; ++e) {
    padded[e] = (count[e] + block_size - 1) / block_size * block_size;
    start[e] = total_padded;
    total_padded += padded[e];
  }
  int64_t num_blocks = total_padded / block_size;
  if (total_padded > cap || num_blocks > bcap) return 3;

  std::fill(sorted_ids, sorted_ids + cap, static_cast<int32_t>(n));
  std::vector<int64_t> cursor(start);  // next free slot per expert
  for (int64_t i = 0; i < n; ++i) {    // stable: ascending source index
    sorted_ids[cursor[eids[i]]++] = static_cast<int32_t>(i);
  }
  std::fill(block_expert, block_expert + bcap, -1);
  for (int32_t e = 0; e < num_experts; ++e) {
    for (int64_t b = start[e] / block_size;
         b < (start[e] + padded[e]) / block_size; ++b) {
      block_expert[b] = e;
    }
  }
  counts[0] = static_cast<int32_t>(num_blocks);
  counts[1] = static_cast<int32_t>(total_padded);
  return 0;
}

}  // namespace

extern "C" {

// The ctypes host-planning entry.
int tdt_moe_align_block_size_host(const int32_t* eids, int64_t n,
                                  int32_t num_experts, int32_t block_size,
                                  int32_t* sorted_ids, int64_t cap,
                                  int32_t* block_expert, int64_t bcap,
                                  int32_t* counts) {
  return AlignBlockSize(eids, n, num_experts, block_size, sorted_ids, cap,
                        block_expert, bcap, counts);
}

}  // extern "C"
