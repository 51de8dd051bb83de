"""medaka_tpu_torch: consensus polishing in PyTorch with CUDA kernels.

The port of ``medaka_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
GPU. Module names follow the JAX package; each module names its
counterpart. Entry points run on CUDA unless the caller passes
``device="cpu"``. The recurrent network of the inference path runs in
hand-written CUDA kernels (``csrc/gru_split.cu``, built with ``nvcc`` on
first use); on the CPU their plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
