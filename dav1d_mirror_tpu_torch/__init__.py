"""dav1d_mirror_tpu_torch — the AV1 decoder of ``dav1d_mirror_tpu``,
ported to PyTorch and CUDA for an NVIDIA H100.

The JAX package beside it is the reference: each module here that has a
counterpart there is held bit-exact against it by ``tests/test_torch_*``.

* ``host/``    — bitstream stage (OBU parsing, native entropy walk, native
                 intra walk), copied from the JAX package.
* ``native/``  — the C++ sources of that stage; built into ``build/``.
* ``ops/``     — pixel ops as PyTorch functions on int32 tensors, and the
                 wrappers of the hand-written CUDA kernels (``mc_cuda``,
                 ``itx_cuda``; their build in ``cuda_build``).
* ``csrc/``    — CUDA C++ sources of those kernels, built with ``nvcc``
                 for ``sm_90a`` at first use (``itx_1d.cuh`` is written by
                 ``tools/gen_itx_cuh.py``).
* ``models/``  — frame planning (numpy) and the per-frame executor.
* ``api.py``   — ``Decoder`` / ``Settings`` / ``Picture``.
"""

__version__ = "0.1.0"
