"""Kernels (``csrc/*.cu``, built by ``_build``), their wrappers and their
plain-torch twins. Nothing here builds or launches at import time."""
