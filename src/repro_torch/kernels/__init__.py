"""Hand-written Hopper kernels of the port (``csrc/*.cu``), their builder
(``build.py``), wrappers (``ops.py``) and plain PyTorch versions
(``ref.py``). A wrapper launches its kernel on CUDA tensors (or raises)
and takes the plain version only for CPU tensors."""
