"""PyTorch/CUDA port of the SimCLR/SupCon pretraining system.

Sits beside the JAX package (``simclr_pytorch_distributed_tpu``), which
stays the reference: public functions keep its layouts (NHWC images,
``[B, V, D]`` features), modules keep the reference ``resnet_big.py``
state-dict names, and the contrastive loss runs as hand-written sm_90a
kernels on the card (``csrc/``, ``ops/fused_loss.py``). This package
imports ``torch``, ``numpy`` and the standard library only.
"""
