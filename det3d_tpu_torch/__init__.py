"""det3d_tpu_torch: the PyTorch + CUDA port of det3d_tpu for one NVIDIA H100.

Inference (points → detections, one frame or a batch), the training step,
the applications (`python -m det3d_tpu_torch`) and the deploy and serve
paths (a `torch.export` artifact replayed as one CUDA graph per frame),
with hand-written CUDA kernels for the BEV canvas scatters, greedy NMS,
the anchor matcher and the train step's fence copy. The JAX package
`det3d_tpu` is the reference this package is tested against; this package
imports nothing from it.
"""
