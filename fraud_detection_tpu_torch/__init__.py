"""PyTorch/CUDA port of ``fraud_detection_tpu`` for one NVIDIA H100.

Module names mirror the JAX package, so each counterpart sits at the same
path (``ops/scorer.py`` here is ``fraud_detection_tpu/ops/scorer.py``
there). The port imports ``torch`` and the standard library, never ``jax``
and nothing of ``fraud_detection_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``DEVICE=cpu`` or a ``device=`` argument); see :mod:`.device`. On the card
the serving path scores through the hand-written CUDA kernel in
``csrc/fused_score.cu`` (:mod:`.ops.kernels`).
"""
