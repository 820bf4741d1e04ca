"""The stand-ins a comparison has to fail: the control (the lower precision
that would tempt a later change) and faults planted under the timed path.
The benchmark's own runs use none of them; ``controls.py`` reads them on
the card and the tests on the CPU.

Serving cells (a fault patches the micro-batcher's flush, in place, after
the program computed it):

- ``half_batch``: the second half of each flush's rows gets the first
  half's scores and reason codes, as if only half had been computed;
- ``altered_answer``: the first row of each flush has its score moved by
  1e-3;
- the control ``bf16_wire``: the program's own bfloat16 h2d wire
  (``SCORER_WIRE=bfloat16``) in place of the configuration's float32.

The fit cell:

- ``unchanged_state``: every boosting step leaves the margins as they
  were (each tree's leaves 0);
- ``half_batch``: each histogram over the first half of the rows, doubled;
- ``altered_answer``: one leaf of the fitted forest moved by 1e-2;
- ``no_min_child_weight``: every split chosen without the recipe's
  min_child_weight test (both sides' hessian at least 1);
- the control ``bf16_grad``: the reference booster in the program's place,
  its gradients and hessians stored in bfloat16 and summed in float32.

One chip: no cell has an exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

LANE_FAULTS = ("half_batch", "altered_answer")
FIT_FAULTS = ("unchanged_state", "half_batch", "altered_answer", "no_min_child_weight")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def lane_fault(name: str):
    from fraud_detection_tpu_torch.service.microbatch import MicroBatcher

    real = MicroBatcher._flush_device

    def flush(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        probs, explain_out = out[0], out[1]
        n = len(probs)
        if name == "half_batch" and n > 1:
            h = n // 2
            probs[h:] = probs[:n - h]
            if explain_out is not None:
                for a in explain_out:
                    a[h:] = a[:n - h]
        elif name == "altered_answer" and n:
            probs[0] += 1e-3
        return out

    if name not in LANE_FAULTS:
        raise ValueError(f"no serving fault {name!r}")
    return _patched(MicroBatcher, "_flush_device", flush)


def fit_fault(name: str):
    import dataclasses

    import torch

    from fraud_detection_tpu_torch.ops import gbt, kernels

    if name == "no_min_child_weight":
        real_grow = gbt._grow_tree

        def grow(binned, g, h, cfg, *args, **kwargs):
            return real_grow(binned, g, h, dataclasses.replace(cfg, min_child_weight=0.0),
                             *args, **kwargs)

        return _patched(gbt, "_grow_tree", grow)
    if name == "unchanged_state":
        real_grow = gbt._grow_tree

        def grow(*args, **kwargs):
            feat, thresh, leaf, row_leaf = real_grow(*args, **kwargs)
            return feat, thresh, torch.zeros_like(leaf), row_leaf

        return _patched(gbt, "_grow_tree", grow)
    if name == "half_batch":
        real_boost = gbt._boost

        def half_hist(bins, local, g, h, n_nodes, n_bins):
            k = bins.shape[0] // 2
            return kernels.gbt_hist(bins[:k].contiguous(), local[:k].contiguous(),
                                    (2 * g[:k]).contiguous(), (2 * h[:k]).contiguous(),
                                    n_nodes, n_bins)

        def boost(binned, y, w, base_logit, cfg, hist=kernels.gbt_hist, **kw):
            return real_boost(binned, y, w, base_logit, cfg, hist=half_hist, **kw)

        return _patched(gbt, "_boost", boost)
    if name == "altered_answer":
        real_fit = gbt.gbt_fit

        def fit(*args, **kwargs):
            model = real_fit(*args, **kwargs)
            leaf = model.leaf_value.clone()
            leaf[leaf.shape[0] // 2, 3] += 1e-2
            return model._replace(leaf_value=leaf)

        return _patched(gbt, "gbt_fit", fit)
    raise ValueError(f"no fit fault {name!r}")


def bf16_grad_fit(session):
    """The fit control: the reference booster grown with bfloat16 gradients
    on the session's input, and its own held-out P(fraud)."""
    import numpy as np
    import torch

    from portbench.reference.booster import Booster
    from portbench.reference.forest import forest_margin

    data = session.data
    forest = Booster(data["x_fit"], data["y_fit"], session.ctx.cfg["model"],
                     device=session.dev, dtype=torch.float32,
                     grad_dtype=torch.bfloat16).grow()
    p = 1.0 / (1.0 + np.exp(-forest_margin(forest, data["x_test"])))
    return forest, p


def variant(cell_kind: str, name: str):
    """``(env, fit_override, context manager)`` of a variant: ``program``,
    ``control`` or ``fault:<name>``."""
    if name == "program":
        return {}, None, contextlib.nullcontext()
    if name == "control":
        if cell_kind == "lane":
            return {"SCORER_WIRE": "bfloat16"}, None, contextlib.nullcontext()
        return {}, bf16_grad_fit, contextlib.nullcontext()
    if name.startswith("fault:"):
        fault = name.split(":", 1)[1]
        cm = lane_fault(fault) if cell_kind == "lane" else fit_fault(fault)
        return {}, None, cm
    raise ValueError(f"no variant {name!r}")
