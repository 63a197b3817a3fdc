"""Hand-written CUDA kernels of the port, one package per TPU kernel it
replaces: ``<name>/ref.py`` (plain PyTorch version), ``<name>/kernel.py``
(launcher of ``csrc/<name>.cu``), ``<name>/ops.py`` (dispatch: CUDA
tensors to the kernel, CPU tensors to the plain version)."""
