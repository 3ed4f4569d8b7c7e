"""Plain references of the benchmark's configurations, one module a
configuration (``<config>.py``), on the shared building blocks of
``plain.py``.

They are plain PyTorch and NumPy in float32 with TF32 off, and import
neither JAX, nor the JAX package, nor anything of ``amt_tools_tpu_torch``:
every table (mel filterbank, wavelet bank, window) is built here again.
Each takes a ``precision`` for its products, so that the same code, computed
in the precision below the configuration's, is the control that the
comparison deciding ``correct`` must fail.
"""
