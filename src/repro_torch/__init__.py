"""PyTorch/CUDA port of :mod:`repro`: the connectome simulator and the
dense LM side-stack with its serving engine.

Module paths mirror the JAX package's (``repro_torch/core/engine.py`` is
the counterpart of ``repro/core/engine.py``).  This package imports
PyTorch and numpy, and nothing of JAX or of :mod:`repro`; the tests in
``tests/test_torch_*.py`` hold it against the JAX package.
"""
