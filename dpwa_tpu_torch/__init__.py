"""dpwa_tpu_torch: the PyTorch/CUDA port of dpwa_tpu's gossip trainer.

The stacked virtual-peer path runs here on one NVIDIA Hopper card: every
peer's replica sits on a leading ``[n_peers, ...]`` axis of one flat
parameter buffer, and the gossip exchange is a hand-written CUDA kernel
(:mod:`dpwa_tpu_torch.ops.merge`).  Three examples drive it: ResNet-20 on
CIFAR-10; the Llama LoRA fine-tune, whose attention is a hand-written CUDA
flash-attention kernel (:mod:`dpwa_tpu_torch.ops.flash_attention`); and the
long-context fine-tune (:mod:`dpwa_tpu_torch.train_sp`), whose sequences
span a virtual sequence-parallel axis walked by ring attention on
hand-written hop kernels (:mod:`dpwa_tpu_torch.ops.flash_ring`) or by
Ulysses.  The TCP transport (:mod:`dpwa_tpu_torch.parallel.tcp`) runs the
reference's deployment, one OS process per node, speaking the reference's
frames byte for byte; each replica stays on the card and each fetched frame
is merged there by the gather-merge kernel.  The package imports torch,
numpy and yaml, never jax or anything of ``dpwa_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
