"""repro_torch — the PyTorch/CUDA port of ``repro`` (Radic determinants of
non-square matrices, served in batches), for NVIDIA Hopper.

It mirrors ``repro`` module for module and imports neither jax nor
``repro``.  Entry points that take host data run on ``"cuda"`` unless the
caller passes ``device="cpu"``; functions that take a tensor compute on
that tensor's device."""

__version__ = "0.1.0"
