"""The benchmark of kinet_tpu_torch (the PyTorch and CUDA port): one
command runs one cell once (``run.py``); ``harness.py`` finds each piece by
name. It imports neither JAX nor the JAX package ``kinet_tpu``."""
