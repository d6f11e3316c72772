"""Plain versions, CUDA kernels and the seams between them."""
