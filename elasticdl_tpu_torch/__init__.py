"""PyTorch/CUDA counterpart of ``elasticdl_tpu`` for NVIDIA Hopper cards.

Module paths mirror the JAX package (``models/resnet.py`` here is the
counterpart of ``elasticdl_tpu/models/resnet.py``).  This package
imports ``torch`` and never JAX, nor anything of ``elasticdl_tpu``:
where it needs code of that package it keeps its own copy.
"""
