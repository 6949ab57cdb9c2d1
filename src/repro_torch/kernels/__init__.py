"""Kernel layer of the PyTorch port: hand-written CUDA kernels for Hopper
(``flash_attention``, ``flash_decode``), their plain PyTorch versions
(``ref``) and the ops the model calls (``ops``)."""
