"""Transforms: framing, STFT, Fourier backends and the CUDA kernels."""
