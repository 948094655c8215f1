"""vision-processor-tpu-torch: the PyTorch + CUDA port of vision_processor_tpu.

The JAX package stays the reference; this package mirrors its layout and
module names and runs the per-camera detection path on one NVIDIA H100:

* ``app.main``        — the camera loop (detection path)
* ``app.processor``   — Processor: per-camera device step + host finishing
* ``ops.pipeline``    — the blob machine: raw frame -> compacted blobs
* ``models.detector`` — robot/ball hypothesis search
* ``ops.cuda``        — build/launch of the hand-written Hopper kernels
                        (``csrc/``): warp band pass, fused blob response,
                        row top-m and query top-m

It imports torch and never jax.
"""

__version__ = "0.1.0"
