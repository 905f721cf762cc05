"""Hand-written Hopper kernels for the compute layers the JAX package wrote
in Pallas.

flash_attention — GQA flash attention forward (csrc/flash_attention.cu) and
                  backward (csrc/flash_attention_backward.cu)
rmsnorm         — fused RMSNorm forward and backward (csrc/rmsnorm.cu)
ssd_scan        — Mamba2 SSD chunked scan forward (csrc/ssd_scan.cu) and
                  backward (csrc/ssd_scan_backward.cu)
embedding_bag   — DLRM pooled lookup, forward and backward
                  (csrc/embedding_bag.cu)

ops.py: each kernel entry as an operator of PyTorch's dispatcher
(``torch.ops.repro_torch.*``: CUDA, CPU and fake implementations) and the
public wrappers over them, each with a launch counter. Each kernel's module
holds its plain PyTorch version beside the function that launches it, and
its work formula ((flops, bytes) from shapes and dtype).
_build.py: nvcc -> one shared library -> ctypes, at first use.
"""

from repro_torch.kernels import ops  # noqa: F401
