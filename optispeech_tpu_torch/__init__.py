"""OptiSpeech in PyTorch for NVIDIA Hopper: the port of `optispeech_tpu`.

The JAX package stays the reference; this package keeps its layout (so the
counterpart of a module is found at the same path), its public (B, T, C)
layout and its padding masks (True = PAD). Plain tensor code is PyTorch; the
fused ConvNeXt block, the one TPU kernel on the synthesis path, is a CUDA
kernel written for sm_90a (`csrc/`, `ops/fused_convnext.py`).

Entry points (`OptiSpeech`, `OptiSpeech.load_from_jax_params`) run on the
card unless a device is given.
"""

__version__ = "0.1.0"
