"""det3d_tpu_torch: the PyTorch + CUDA port of det3d_tpu for one NVIDIA H100.

Single-frame inference (points → detections) with hand-written CUDA
kernels for the BEV canvas scatter and greedy NMS. The JAX package
`det3d_tpu` is the reference this package is tested against; this package
imports nothing from it.
"""
