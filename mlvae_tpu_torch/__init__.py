"""PyTorch/CUDA port of ``mlvae_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``nn/``, ``ops/``,
``modules/``, ``models/MD_VAE/``, ``utils/``, ``cli/``) and imports
nothing of it and nothing of JAX. It trains, tests and serves MD_VAE
through the JAX package's entry points (``cli.train``, ``cli.test``,
``cli.infer`` on the recipe YAML, the SynAudioMNIST data path and
checkpoints in the JAX layout), trains LSTM_FC and the gate configs, in
f32 and under AMP, with every TPU kernel as a hand-written CUDA kernel
(``csrc/``) beside its plain PyTorch version.

Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
