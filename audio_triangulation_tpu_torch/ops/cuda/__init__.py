"""CUDA kernels (``csrc/*.cu``) and their ctypes wrappers."""
