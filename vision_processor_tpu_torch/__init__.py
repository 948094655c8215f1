"""vision-processor-tpu-torch: the PyTorch + CUDA port of vision_processor_tpu.

The JAX package stays the reference; this package mirrors its layout and
module names and runs on NVIDIA H100 cards:

* ``app.main``           — the camera loop (detection, idle and calibration
                           paths, debug stream)
* ``app.multicam_app``   — N cameras on one card
* ``app.processor``      — Processor: per-camera device step + host finishing
* ``ops.pipeline``       — the blob machine: raw frame -> compacted blobs
* ``models.detector``    — robot/ball hypothesis search
* ``io.camera``          — ``open_camera``: OPENCV replay, and the hardware
                           drivers ``io.native`` (V4L2, native multicast),
                           ``io.vendor`` (Spinnaker, mvIMPACT) and
                           ``io.genicam`` (Aravis)
* ``parallel.multicam``  — the camera batch on one card, and the camera mesh
                           over ``torch.distributed`` (``make_camera_group``,
                           ``sharded_step``, ``sharded_rollout``)
* ``ops.cuda``           — build/launch of the hand-written Hopper kernels
                           (``csrc/``)

It imports torch and never jax.
"""

__version__ = "0.1.0"
