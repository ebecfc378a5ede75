"""The port's ops. Importing the package registers the kernels K1-K6 as
custom ops in the namespace `maskrcnn_tpu_torch` (`torch.ops.
maskrcnn_tpu_torch.*`): each op runs its plain PyTorch version on CPU
tensors and its CUDA kernel on CUDA tensors. A program saved by
`io/export.py` calls these ops, so it loads only after this import."""

from maskrcnn_tpu_torch.ops import (bottleneck_cuda, nms_cuda,  # noqa: F401
                                    roi_align_cuda, stem_cuda)
