"""Per-stage torch ops and the CUDA kernels they launch (ops/*_cuda.py)."""
