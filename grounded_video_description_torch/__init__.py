"""Grounded Video Description, PyTorch / CUDA port.

The JAX package ``grounded_video_description_tpu`` is the reference; this
package computes the same functions in PyTorch, with hand-written CUDA
kernels for Hopper where the JAX package has Pallas kernels.  It has its
own ``config`` and ``data.synthetic`` (the JAX package's, restricted to
what the port runs) and imports nothing of JAX or of the JAX package.
"""
