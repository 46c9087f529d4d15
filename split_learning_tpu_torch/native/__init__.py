"""Native (C++) host codec, ctypes-bound (counterpart of
``split_learning_tpu/native``).

The host-side wire ops of the numpy line of ``transport/codec.py`` --
int8 quantize/dequantize of the cut-layer tensor, the topk8 select and
scatter, and frame checksumming -- compiled from ``slt_codec.cc`` at
first use. A failed build raises; ``SLT_NO_NATIVE=1`` selects the numpy
line. See codec.py.
"""

from split_learning_tpu_torch.native.codec import (  # noqa: F401
    NativeBuildError, available, build_error, crc32, q8_dequantize,
    q8_quantize, topk8_scatter, topk8_select)
