"""Tensor ops of the port: crop, pooling, upsampling and the CUDA kernels."""
