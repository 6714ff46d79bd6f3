"""MagicDrive in PyTorch for one NVIDIA Hopper GPU.

The PyTorch counterpart of ``magicdrive_tpu``: the same 6-view generation
path (CLIP, camera/box/map conditioning, BEVControlNet + multiview UNet with
CFG, UniPC, VAE decode) and its training step, with the JAX package's eight
Pallas kernels (K1-K8) rewritten as CUDA C++ for sm_90a (``kernels/csrc``).
Module layout and names follow the JAX package so each counterpart is easy
to find; tensors are NCHW inside and the JAX package's layouts are kept at
the public entry points, which build on the card unless the caller asks for
the CPU (``device.py``).

This package imports torch and never jax or flax, nor anything of
``magicdrive_tpu``: its generation requests come from ``data`` (fixture
scenes and their collated batches, in numpy).
"""

__version__ = "0.1.0"
