"""maskrcnn_tpu_torch — Mask-RCNN inference and training in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `maskrcnn_tpu` (JAX/Pallas), module for module: each file here
mirrors the file of the same path there. The JAX package stays the reference
the port is tested against; this package imports neither JAX nor anything of
`maskrcnn_tpu`.

Entry points (`pipeline.detector.MaskRCNNDetector`, `models.mask_rcnn.forward`,
the CLI, and for training `train.step.train_step` on params placed by the
caller) run on `cuda` unless the caller passes `device="cpu"`. On a CUDA tensor the
kernel wrappers in `ops/*_cuda.py` launch their kernels (built from `csrc/`
with nvcc at first use); on a CPU tensor they run their plain PyTorch
versions.
"""

__version__ = "0.1.0"
