"""coarse3d_tpu_torch — the PyTorch / CUDA port of coarse3d-tpu for NVIDIA Hopper.

The JAX package beside it stays the reference: every module here mirrors the
name of its counterpart there and is held against it by ``tests/test_torch_*``.
The port imports torch, numpy and yaml only, never JAX nor the JAX package
(it keeps its own copies of the framework-free modules it needs).

Entry points run on the card (``device="cuda"``) and raise when there is
none; pass ``device="cpu"`` to run on the CPU. On a CUDA tensor the
projection scatter-min and the KNN vote run as hand-written CUDA kernels
(``csrc/``, built with nvcc at first use); on a CPU tensor they run their
plain PyTorch twins.
"""

__version__ = "0.1.0"
