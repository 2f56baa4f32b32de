"""sd-video-gen on PyTorch + CUDA (Hopper): the port of ``sd_video_gen_tpu``.

Module names mirror the JAX package so the counterpart of every file is easy
to find. Public functions keep the JAX package's layouts (NHWC uint8 BGR
frames, ``(B, T, latent_dim)`` channel-major flat latents, ``(BH, T, d)``
attention) so the two can be compared like with like; the models run NCHW
inside. Attention-heavy spatial layers go through the hand-written CUDA
kernel in ``csrc/`` on a GPU and through its plain PyTorch version on the CPU.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
