"""PyTorch/CUDA port of ``mlvae_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``nn/``, ``ops/``,
``modules/``, ``models/MD_VAE/``, ``utils/``, ``cli/``) and imports
nothing of it and nothing of JAX. It serves MD_VAE (the TEST-target eval
step and a features-in ``infer``) and trains it in f32 (``fit_batch``,
``training/``), with the LSTM recurrence forward and backward and the
MD-Viterbi decode as hand-written CUDA kernels (``csrc/``) beside their
plain PyTorch versions.

Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
