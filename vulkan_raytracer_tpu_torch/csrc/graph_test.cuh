// A loop's or an IF's test made by the kernel that makes its count: shared
// by loop_cond_kernel (csrc/graph_loops.cu), which counts a column of lane
// flags, alpha_commit_kernel (csrc/wave.cu), which counts the lanes a
// resample pass leaves pending, and instance_step_kernel (csrc/trace.cu),
// which counts the lanes that touch the next instance's box.
//
// Every block of such a kernel adds its own count and one block ticket into
// one 64-bit word with a single atomicAdd: the high 32 bits count the blocks
// done, the low 32 the lanes.  The block whose ticket is the grid's last
// finds the total in what its atomic returned, so it needs no second pass, no
// memset node and no fence for the count.  It stores 0 back, so the word is
// ready for the next launch (the graph orders the next one after this one),
// and its thread 0 makes the test: it reads the loop's device scalars, keeps
// the node's row of five counters (iterations, entries, the bodies of the
// current entry, the most bodies one entry ran, the sum of the counts that
// let a body run: render/graphs.py ROW_WORDS) and calls
// cudaGraphSetConditional.  A wave holds fewer than
// 2**32 lanes and a grid fewer than 2**32 blocks.

#pragma once

#include <cuda_runtime.h>

namespace {

// Adds the block's `count` (thread 0's) and its ticket into *word; true in
// thread 0 of the grid's last block, which gets the grid's total and leaves
// *word at 0.  Every thread of the block calls it after a __syncthreads that
// made its count final.
__device__ __forceinline__ bool last_block(unsigned long long* word, unsigned int count,
                                           long long& total) {
  if (threadIdx.x != 0) return false;
  const unsigned long long old = atomicAdd(word, (1ULL << 32) | count);
  if ((old >> 32) != gridDim.x - 1) return false;
  total = static_cast<long long>(old & 0xFFFFFFFFULL) + count;
  *word = 0;
  return true;
}

// The node's row after one test of `count`: a new entry starts its bodies
// from 0; an iteration counts, with the count that let it run; a stop keeps
// the most bodies one entry ran.
__device__ __forceinline__ void keep_row(long long* row, bool entry, bool go, long long count) {
  if (entry) {
    row[1] += 1;
    row[2] = 0;
  }
  if (go) {
    row[0] += 1;
    row[2] += 1;
    row[4] += count;
  } else if (row[2] > row[3]) {
    row[3] = row[2];
  }
}

// The block's sum of one unsigned per thread, in thread 0 (the block's
// threads a multiple of 32, at most 1024).
__device__ __forceinline__ unsigned int block_sum(unsigned int v) {
  __shared__ unsigned int warp_sums[32];
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int sum = 0;
  if (threadIdx.x == 0) {
    for (unsigned int w = 0; w < (blockDim.x + 31) / 32; ++w) sum += warp_sums[w];
  }
  return sum;
}

}  // namespace
