"""ndtpu_torch — the PyTorch/CUDA port of ndtpu (2D laser SLAM).

Module paths mirror ``ndtpu/`` so each port sits where its JAX counterpart
does (``ndtpu_torch/ndt/match.py`` <-> ``ndtpu/ndt/match.py``). The JAX
package stays the reference; every ported function is tested against it on
the same numpy inputs.

Rules of the port:

- It imports ``torch`` and ``numpy``, never ``jax`` and nothing of the JAX
  package ``ndtpu`` (``ndtpu_torch.config`` is its own copy of the
  configuration dataclasses).
- No learned parameters and no gradients: plain functions on tensors, state
  as ``NamedTuple``s with the JAX package's field names.
- Plain functions follow their input dtype (f64 in the CPU tests, f32 on the
  card). The hand-written CUDA kernels (``ndtpu_torch.kernels``) take f32
  (K11 ``raycast`` also f64, in which ``make_sequence`` simulates); each
  has a plain twin that CPU tensors go to.
- Every entry point takes an explicit ``device``.
"""

__version__ = "0.1.0"
