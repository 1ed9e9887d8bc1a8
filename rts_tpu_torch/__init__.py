"""rts_tpu_torch — the radar ray tracer of ``rts_tpu``, on PyTorch and CUDA.

A second package beside ``rts_tpu`` (the JAX/Pallas reference, which it
never imports).  Module names mirror ``rts_tpu`` one to one:

  * ``core``      — vector math, rotations, constants.
  * ``geometry``  — rect / icosphere / terrain / file meshes, scene compiler
                    (NumPy host code carried over from ``rts_tpu``).
  * ``accel``     — Morton clustering (host) and cluster AABBs (device).
  * ``engine``    — per-pulse animation, fan, brute-force intersector,
                    wavefront bounce loop, CPI.
  * ``ops``       — the clustered closest-hit traversal: phase 1 in
                    PyTorch, phase 2 a hand-written CUDA kernel
                    (``ops/csrc/mt_traverse.cu``) with its plain PyTorch
                    version beside it.
  * ``physics``   — receiver geometry, antennas, RCS, post-processing.
  * ``aggregate`` — multipath coherent combining (stable sort + segment sums).
  * ``sim``       — World / Transmitter / Receiver / Target, ``prepare_cpi``,
                    the sequential driver ``run``, range-Doppler rendering,
                    scene files, export and sweeps.
  * ``utils``     — phase timing, scene validation.

``python -m rts_tpu_torch run|info scene.xml`` is the command line.

Tensors live on the device given to ``sim.prepare_cpi(..., device=...)``
or ``sim.run(..., device=...)``, the card (``"cuda"``) unless the caller
asks for the CPU.
Nothing on the path has a gradient; callers run it under
``torch.no_grad()`` or not, it makes no difference to the values.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-f32 matrix products and convolutions, as rts_tpu pins
# jax_default_matmul_precision="highest": TF32 keeps ~10 mantissa bits,
# which would silently corrupt the few small contractions on the path
# (the brute-force intersector's K=3 products among them).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from rts_tpu_torch.config import Parameters

__all__ = ["Parameters", "__version__"]
