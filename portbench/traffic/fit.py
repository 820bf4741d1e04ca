"""Whole fits of the recipe's forest, one after another.

Set-up makes the recipe's final-fit input from the seed (the whole file,
its 80/20 stratified split, a scaler on the 80%, SMOTE), puts it on the
device and fits once (the kernels' libraries load, the allocator warms).
The window then calls ``ops/gbt.gbt_fit`` the way ``train._fit_gbt``
does (the default mesh, ``sharded=True``) until ``--seconds`` have passed;
the fit under way then finishes. The last fit's forest and its P(fraud)
on the held-out rows are judged by the reference booster once the window
has closed.

Mix parameters (``traffic/mixes/<mix>.json``): ``trace_fits``, the whole
fits a traced run profiles (from the second of the window on).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench import inputs
from portbench.reference.booster import Booster


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = None
        self.forest = None
        self.p_test = None

    def setup(self) -> None:
        import torch

        from fraud_detection_tpu_torch.device import resolve_device
        from fraud_detection_tpu_torch.ops.gbt import GBTConfig

        ctx, m = self.ctx, self.ctx.cfg["model"]
        self.data = inputs.fit_inputs(ctx.cfg, ctx.seed)
        self.dev = resolve_device(ctx.device)
        self.x = torch.from_numpy(self.data["x_fit"]).to(self.dev)
        self.y = torch.from_numpy(self.data["y_fit"]).to(self.dev)
        self.gbt_cfg = GBTConfig(
            n_trees=m["n_trees"], max_depth=m["max_depth"], learning_rate=m["learning_rate"],
            n_bins=m["n_bins"], reg_lambda=m["reg_lambda"], gamma=m["gamma"],
            min_child_weight=m["min_child_weight"], scale_pos_weight=m["scale_pos_weight"],
        )
        self.fit = ((lambda: ctx.fit_override(self)) if ctx.fit_override is not None
                    else self._program_fit)
        self.fit()  # loads the kernels, warms the allocator: every shape the window runs

    def _program_fit(self):
        from fraud_detection_tpu_torch.ops.gbt import gbt_fit
        from fraud_detection_tpu_torch.parallel.mesh import default_mesh

        return gbt_fit(self.x, self.y, self.gbt_cfg, mesh=default_mesh(self.dev), sharded=True)

    def window(self, seconds: float, tracer) -> dict:
        trace_fits = int(self.ctx.mix["trace_fits"]) if tracer is not None else 0
        times, model, out = [], None, {}
        t0 = time.perf_counter()
        while True:
            if trace_fits and len(times) == 1:
                tracer.start()
            ts = time.perf_counter()
            model = self.fit()
            times.append(time.perf_counter() - ts)
            if trace_fits and len(times) == 1 + trace_fits:
                out["trace"] = tracer.stop()
                out["trace_fits"] = trace_fits
            if time.perf_counter() - t0 >= seconds and (not trace_fits or "trace" in out):
                break
        out["elapsed_s"] = time.perf_counter() - t0
        out["rows"] = int(self.x.shape[0])
        out["fit_times_s"] = times
        out["attempted"] = len(times)
        out["failed"] = 0
        self._keep(model)
        return out

    def _keep(self, model) -> None:
        """The judged outputs, on the host: the forest and its held-out
        P(fraud), which the program computes itself."""
        import torch

        from fraud_detection_tpu_torch.ops.gbt import GBTModel, gbt_predict_proba

        if isinstance(model, GBTModel):
            x_test = torch.from_numpy(self.data["x_test"]).to(self.dev)
            self.p_test = gbt_predict_proba(model, x_test).cpu().numpy()
            self.forest = {k: getattr(model, k).detach().cpu().numpy()
                           for k in ("split_feature", "split_bin", "leaf_value", "bin_edges")}
        else:  # a stand-in for the program (the control) brings both
            self.forest, self.p_test = model

    def teardown(self) -> None:
        import torch

        self.x = self.y = None
        gc.collect()
        if self.dev is not None and self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        judge = Booster(self.data["x_fit"], self.data["y_fit"], self.ctx.cfg["model"],
                        device=self.dev)
        return judge.judge(self.forest, self.data["x_test"], np.asarray(self.p_test))
