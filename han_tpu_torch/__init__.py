"""han_tpu_torch — the PyTorch + CUDA port of han_tpu for NVIDIA Hopper.

The package mirrors ``han_tpu``'s layout and names so that each module's
counterpart is easy to find. It imports ``torch`` and never ``jax`` (nor
``han_tpu``, whose package import loads jax): the numpy host code it needs
is copied, and ``tests/test_torch_*.py`` hold each copy equal to the
original. Its kernels — the block-sparse flash-GAT forward and backward,
the fused ELL attention forward of the sampled path, and the calibration
kernels behind the benchmark's roofline — are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` on first use
(``ops/_build.py``).

Importing this package imports nothing else.
"""
