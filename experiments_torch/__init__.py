"""The PyTorch/CUDA port's experiments, counterparts of ``experiments/``
by file name (analytical, on the CPU)."""
