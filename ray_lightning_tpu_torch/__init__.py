"""PyTorch/CUDA port of ``ray_lightning_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``models/gpt.py``,
``models/generate.py``, ``ops/lora.py``, ``serve/engine.py``, ...) so each
module has an obvious counterpart, and keeps its parameter layout at every
public function: the stacked ``blocks`` dict with a leading ``n_layer``
axis, weights stored ``(in, out)`` and applied as ``h @ W``.  It imports
``torch`` and never ``jax`` nor anything of ``ray_lightning_tpu``.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back.  Hand-written CUDA
kernels (``ops/csrc``) replace the JAX package's Pallas kernels; each has
a plain PyTorch version beside it, which CPU tensors run.
"""
