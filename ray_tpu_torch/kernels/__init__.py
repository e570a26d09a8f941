"""Hand-written CUDA kernels of the port (sources under `csrc/`), their
build (`build.py`) and their PyTorch wrappers. A wrapper launches its
kernel for CUDA tensors and runs the kernel's plain PyTorch version for CPU
tensors only."""
