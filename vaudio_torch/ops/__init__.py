"""The hand-written CUDA kernels and their plain PyTorch versions (port of
:mod:`vaudio.ops`): K1 :mod:`.pool_kernel`, K2 :mod:`.spectrum_kernel`."""
