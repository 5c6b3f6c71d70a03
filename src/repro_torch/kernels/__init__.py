"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops.py`` holds the entry points the generators call, ``ref.py`` the
plain versions, ``edge_resolve.py``, ``histogram.py``,
``band_compact.py``, ``pk_expand.py`` and ``cfree_expand.py`` the
wrappers of the CUDA sources in ``csrc/``, built on first use by
``_build.py``.
"""
