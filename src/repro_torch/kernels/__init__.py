"""The port's kernels: APack decode and encode and the fused paged
attention, each a CUDA C++ kernel for sm_90a (``csrc/``) with a wrapper that
checks its arguments and a plain PyTorch version that CPU tensors take."""
