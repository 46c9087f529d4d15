"""split_learning_tpu_torch — the PyTorch/CUDA port of split_learning_tpu.

The JAX package beside it stays the reference; each module here has the
same path and names as its JAX counterpart, so a reader finds one from
the other. The port imports ``torch``, ``numpy`` and the standard
library only: never ``jax`` and nothing of ``split_learning_tpu``.

The device decides how a kernel runs. Every entry point takes
``device`` (default ``"cuda"``) and raises when CUDA is asked for and
absent. On a CUDA tensor a kernel wrapper launches its hand-written
Hopper kernel (``csrc/*.cu``, built at first use by
:func:`split_learning_tpu_torch.ops.common.load_kernels`) or raises; the
plain PyTorch version runs only for CPU tensors.
"""

__version__ = "0.1.0"
