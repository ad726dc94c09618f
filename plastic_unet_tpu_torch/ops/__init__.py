"""Ops of the port. The CUDA kernels (plastic_head, conv3x3 and the
residual_tail built on it) are built from ``csrc/`` on first launch only."""
