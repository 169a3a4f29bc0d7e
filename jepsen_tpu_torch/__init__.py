"""jepsen_tpu_torch: the PyTorch/CUDA port of jepsen_tpu's checking
backend, for NVIDIA Hopper (sm_90a).

It stands beside the JAX package and imports nothing of it: host-only
modules the port needs (history, models, encode, synth, certify) are
kept as its own copies under the same names. Device work goes through
kernels written by hand in CUDA C++ (gpu/kernels/csrc), built with nvcc
at first use and bound with ctypes. Entry points run on the card unless
the caller passes device="cpu", where each kernel's plain PyTorch
version runs instead.
"""
