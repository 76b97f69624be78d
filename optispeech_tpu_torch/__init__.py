"""OptiSpeech in PyTorch for NVIDIA Hopper: the port of `optispeech_tpu`.

The JAX package stays the reference; this package keeps its layout (so the
counterpart of a module is found at the same path), its public (B, T, C)
layout and its padding masks (True = PAD). Plain tensor code is PyTorch; the
TPU kernels on the ported paths are CUDA kernels written for sm_90a
(`csrc/`): the fused ConvNeXt block of synthesis (`ops/fused_convnext.py`)
and the monotonic alignment search of training (`ops/mas.py`).

Entry points (`OptiSpeech`, `OptiSpeech.load_from_jax_params`,
`training.state.init_train_state`) run on the card unless a device is
given.
"""

__version__ = "0.1.0"
