"""dpwa_tpu_torch: the PyTorch/CUDA port of dpwa_tpu's gossip trainer.

The stacked virtual-peer path runs here on one NVIDIA Hopper card: every
peer's replica sits on a leading ``[n_peers, ...]`` axis of one flat
parameter buffer, and the gossip exchange is a hand-written CUDA kernel
(:mod:`dpwa_tpu_torch.ops.merge`).  Two examples drive it: ResNet-20 on
CIFAR-10, and the Llama LoRA fine-tune whose attention is a hand-written
CUDA flash-attention kernel (:mod:`dpwa_tpu_torch.ops.flash_attention`).  The package imports torch, numpy and
yaml, never jax or anything of ``dpwa_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
