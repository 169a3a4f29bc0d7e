"""Kernels written by hand for Hopper, each with its plain PyTorch
version and a launch counter (see build.py for how they are built)."""
