// The selective scan's checkpoint interval, shared by its forward
// (selective_scan.cu, whose training instance stores h at the start of
// every chunk of this many steps) and its backward (selective_scan_bwd.cu,
// which recomputes one such chunk at a time with its h_t and a_t in
// registers): 16 steps up to N = 16 states, 8 up to 32, 4 up to 64.
// kernels/ref.py scan_checkpoint_steps is the same rule for the wrappers.
#pragma once

__host__ __device__ constexpr int ckpt_steps(int N) {
  return N <= 16 ? 16 : N <= 32 ? 8 : 4;
}
