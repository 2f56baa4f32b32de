"""Attention (CUDA kernel + plain version), masks and the AR rollout."""
