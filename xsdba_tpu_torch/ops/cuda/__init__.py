"""Hand-written CUDA kernels, each built from ``csrc/`` at its first CUDA
call and bound with ``ctypes``; importing needs neither ``nvcc`` nor a GPU."""
