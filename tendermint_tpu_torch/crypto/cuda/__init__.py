"""Device-side ed25519 verification for the GPU: PyTorch host glue and
hand-written CUDA kernels (sources in tendermint_tpu_torch/csrc).

The counterpart of the reference's crypto/tpu. Each kernel wrapper
uses its plain PyTorch version for CPU tensors and launches its kernel
for CUDA tensors (raising KernelError when it cannot build or launch).
"""
