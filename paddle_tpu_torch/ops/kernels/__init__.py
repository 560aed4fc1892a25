"""Hand-written CUDA kernels (sources in ``paddle_tpu_torch/csrc``): one
module per kernel, holding its wrapper (with a ``launches`` counter), its
plain PyTorch version and nothing else. The wrappers are reached through
their modules (``kernels.rms_norm.rms_norm``), whose names they share."""
