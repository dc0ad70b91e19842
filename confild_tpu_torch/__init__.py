"""PyTorch / CUDA port of ``confild_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``core/``, ``models/``,
``ops/``, ``diffusion/``, ``guidance/``, ``inference.py``, ``cli/``; the
turbulence demo in ``examples/``) and
keeps the reference PyTorch state-dict keys, so reference ``.pt`` files and
the JAX package's ``.ckpt`` pytrees both load (``io/convert.py``).

It imports neither ``jax`` nor ``confild_tpu``.  The SIREN-FiLM decode
kernels (``ops/siren_decode.py``) are hand-written CUDA C++ for ``sm_90a``
(``csrc/siren_fwd_cluster.cu``, ``csrc/siren_chain_cluster.cu``,
``csrc/siren_decode_bwd.cu``), built with ``nvcc`` at first use.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from confild_tpu_torch.device import resolve_device  # noqa: F401
