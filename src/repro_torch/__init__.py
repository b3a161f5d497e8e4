"""PyTorch + CUDA port of the HSS-ADMM kernel SVM and of the LM serving path of
the ssm / hybrid families (``repro`` is the JAX reference).

The module layout mirrors ``repro``: ``core/tree.py`` here is the
counterpart of ``repro/core/tree.py``, and so on.  Every kernel that the
JAX package wrote in Pallas has a hand-written CUDA twin under ``csrc/``,
reached through ``kernels/<name>/ops.py``.  This package imports torch,
numpy and scipy only — never jax, and nothing of ``repro``.

Entry points place their tensors on ``device="cuda"`` unless the caller
passes another device; on CPU tensors every kernel wrapper runs its plain
PyTorch version, which is how the tests hold the port against ``repro``.
"""
