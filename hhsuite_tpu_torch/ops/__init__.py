"""Viterbi kernels (CUDA wrappers with plain PyTorch versions) and the
device-side path walks."""
