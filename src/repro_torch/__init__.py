"""PyTorch/CUDA port of the connectome simulator in :mod:`repro`.

Module paths mirror the JAX package's (``repro_torch/core/engine.py`` is
the counterpart of ``repro/core/engine.py``).  This package imports
PyTorch and numpy, and nothing of JAX or of :mod:`repro`; the tests in
``tests/test_torch_*.py`` hold it against the JAX package.
"""
