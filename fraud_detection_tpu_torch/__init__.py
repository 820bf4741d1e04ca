"""PyTorch/CUDA port of ``fraud_detection_tpu`` for one NVIDIA H100.

Module names mirror the JAX package, so each counterpart sits at the same
path (``ops/scorer.py`` here is ``fraud_detection_tpu/ops/scorer.py``
there). The port imports ``torch`` and the standard library, never ``jax``
and nothing of ``fraud_detection_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``DEVICE=cpu`` or a ``device=`` argument); see :mod:`.device`. On the card
the serving and training paths run through the hand-written CUDA kernels
in ``csrc/`` (:mod:`.ops.kernels`): ``fused_score`` and ``tree_shap`` in
the flush, ``knn_topk`` in SMOTE, ``gbt_hist`` in the forest's fit.
"""
