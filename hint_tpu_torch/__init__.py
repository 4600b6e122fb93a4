"""hint_tpu_torch — the PyTorch/CUDA port of hint_tpu.

The JAX package ``hint_tpu`` is the reference; this package holds the same
parameter trees and checkpoints and is tested against it. It imports torch,
numpy and the standard library only, never JAX or ``hint_tpu``. Entry points
run on CUDA unless the caller passes ``device="cpu"``; the HAC block's
``impl="fused"`` engine is a hand-written CUDA kernel (ops/csrc/hac_block.cu).
"""

__version__ = "0.1.0"
