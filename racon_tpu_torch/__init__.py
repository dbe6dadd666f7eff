"""racon_tpu_torch: the PyTorch/CUDA port of racon-tpu for NVIDIA Hopper.

Contig polishing end to end — parse, align reads to draft spans, build
windows, refine each window's consensus, stitch — with the device work in
hand-written CUDA kernels (``ops/kernels``). The JAX package ``racon_tpu``
stays the reference: every engine here is held byte-for-byte against it.
The package imports ``torch`` and numpy, never ``jax`` or ``racon_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a host without a card raises.
"""

__version__ = "0.1.0"
