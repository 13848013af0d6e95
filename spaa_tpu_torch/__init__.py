"""spaa_tpu_torch: the SPAA attack system in PyTorch, for one NVIDIA H100.

A port of ``spaa_tpu`` (JAX/Flax/Pallas on a TPU), which stays in the
repository as the reference. This package holds the SPAA and
PerC-AL+CompenNet++ attackers from captures to the paper's table: the
analytic ProCams simulator that writes a setup, PCNet and CompenNet++
training and validation, the frozen PCNet with its baked warp grid, the
ResNet-18 / VGG-16 / Inception-v3 classify pipelines, the CIEDE2000 colour
losses, the fused SPAA sweep and the PerC-AL loop, the replay of their
projections and the summarize into stats tables, montages and the pivot
(``main`` and ``reproduce_paper_results`` are the entry scripts). The one
TPU kernel on SPAA's path, the fixed-grid bilinear warp, is a CUDA C++
kernel written for ``sm_90a`` (``csrc/fixed_warp.cu``); PerC-AL's path has
none.

Ground rules:

- No JAX and no ``spaa_tpu``. Nothing here imports ``jax``, ``flax`` or any
  module of ``spaa_tpu``; what it needs of them is copied.
- No host packages the GPU machine lacks: no ``cv2``, ``PIL``, ``yaml``,
  ``pandas``, ``flax`` or ``msgpack``. PNG, the flat ``setup_info.yml``,
  the ``.flax`` checkpoint, the stats tables and ``.xlsx`` are read and
  written with the standard library and numpy; OpenCV's image operations
  are reproduced in numpy, and Pillow's label text from a committed glyph
  atlas.
- Module names follow ``spaa_tpu`` so each piece has an obvious
  counterpart; inside, the idiom is PyTorch's: ``nn.Module``s, plain
  functions on tensors, an explicit ``device``, explicit
  ``torch.Generator``s and a ``torch.autograd.Function`` for the warp.
- Public functions take and return NHWC images, as ``spaa_tpu`` does, so
  the two packages can be compared like for like. Modules run NCHW inside.
- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
  and raise when no GPU is present and the CPU was not asked for. On a
  CUDA tensor the warp launches its kernel or raises; its plain PyTorch
  version runs only for tensors on the CPU.
- Numerics are strict float32: entry points turn TF32 off for cuDNN
  convolutions and cuBLAS matrix products (see ``utils.device``).
"""
