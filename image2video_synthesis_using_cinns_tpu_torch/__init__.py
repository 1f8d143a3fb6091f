"""PyTorch + CUDA port of the image-to-video cINN sampler.

A second package beside the JAX one (``image2video_synthesis_using_cinns_tpu``),
which stays the numerical reference. This package imports torch and numpy
only; its tests compare it with the JAX package on the CPU.

Layouts inside the package are PyTorch's (NCHW images, NCDHW videos). The
public ``Model`` keeps the JAX facade's boundary layout: x0 is (B, C, H, W)
and a video is (B, T, C, H, W), both in [-1, 1].
"""
