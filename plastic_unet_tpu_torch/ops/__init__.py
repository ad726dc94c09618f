"""Ops of the port. The CUDA kernels (plastic_head, conv3x3, conv3x3_wgrad
and residual_tail's fused forward) are built from ``csrc/`` on first launch only."""
