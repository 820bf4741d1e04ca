"""Hot model swap: a promotion reaches the serving path with no restart.

The port's copy of the JAX package's ``lifecycle/swap.py``.
:class:`ModelSlot` holds the served model behind ONE reference. The
micro-batcher reads the slot once a flush (and the binary lane once a
frame), so a swap lands *between* device dispatches: a batch in flight
finishes on the old params, the next batch scores with the new — no
dropped requests and no lock on the hot path (an attribute store is atomic
under the GIL, and the tuple means a reader never sees a half-updated
model/version pair).

:class:`ModelReloader` watches the registry aliases (poll and/or ``POST
/admin/reload``) and drives the slot: when ``@prod`` moves it loads the new
champion on the serving device, **warms the bucket ladder off the request
path** (:func:`warm_scorer`, :func:`warm_fused_ladder`: the kernels built,
the allocator's blocks cached, so the swap itself is a pointer write),
swaps, and rebinds the watchtower's baseline profile (and, for a ledger
champion, its stamped table); when ``@shadow`` moves it rebinds the
challenger. A cross-family swap (logistic ↔ forest) and a cross-width swap
(narrow → ledger or wide) are handled alike: the wire schema (the base
feature names) is the condition, and the drift monitor is rebuilt from the
new champion's profile. ``lifecycle_model_swaps`` counts swaps and
``lifecycle_active_model_version`` exports what is serving.

Both warm-ups run inside the compile sentinel's ``expected_compiles``
mark, as the reference's do: the kernel libraries a promotion's warm-up
builds or loads count in ``xla_compiles_total`` but never feed the
recompile-storm detector.
"""

from __future__ import annotations

import logging
import threading

from fraud_detection_tpu_torch import config
from fraud_detection_tpu_torch.ops import scorer as scorer_mod
from fraud_detection_tpu_torch.ops.scorer import _bucket
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.telemetry.compile_sentinel import expected_compiles
from fraud_detection_tpu_torch.utils import lockdep

log = logging.getLogger("fraud_detection_tpu_torch.lifecycle")


class ModelSlot:
    """The single swappable reference to (model, source, version)."""

    def __init__(self, model, source: str, version: int | None = None):
        self._ref = (model, source, version)

    def get(self) -> tuple:
        return self._ref  # one attribute read — an atomic snapshot

    @property
    def model(self):
        return self._ref[0]

    @property
    def source(self) -> str:
        return self._ref[1]

    @property
    def version(self) -> int | None:
        return self._ref[2]

    def swap(self, model, source: str, version: int | None = None) -> None:
        self._ref = (model, source, version)
        metrics.lifecycle_model_swaps.inc()
        metrics.lifecycle_active_model_version.set(version or 0)
        log.warning("model slot swapped → %s (v%s)", source, version)


def _base_names(model) -> list:
    """The wire schema a client sends: a widened family (ledger, wide)
    extends ``feature_names`` with device-computed columns but keeps the
    base schema."""
    return list(getattr(model, "base_feature_names", model.feature_names))


def warm_scorer(scorer) -> None:
    """Score one zero batch per bucket of the ladder up to
    ``SCORER_MAX_BATCH`` for a freshly loaded model (both widths of a
    widened scorer), so the swap pause is a pointer write: the kernel is
    built and the allocator's blocks are cached before the first post-swap
    flush. Runs under ``expected_compiles``: a reload's ladder is not a
    recompile storm."""
    with expected_compiles():
        scorer.warmup(_bucket(config.scorer_max_batch(), scorer.min_bucket))


def warm_fused_ladder(
    watchtower,
    scorer,
    max_batch: int | None = None,
    explain_k: int | None = None,
    drift=None,
) -> None:
    """Run the FUSED flush once a bucket for a freshly loaded model before
    it swaps in: the return wire serving uses, and the explain leg when
    ``SCORER_EXPLAIN=topk``. A cross-family promotion (linear ↔ forest)
    binds another score body and explain leg (the ``tree_shap`` kernel's
    tables), so without this the first post-swap flush would build them
    under live traffic. No-op without a fused target (no watchtower, no
    drift monitor, no fused spec). ``drift`` overrides the monitor the warm
    drives: a CROSS-WIDTH promotion (narrow → wide / ledger) changes the
    drift window's width, so the warm runs against a monitor built from
    the NEW champion's profile. The warm folds nothing into the window
    (all-padding batches). Runs under ``expected_compiles``: a promotion's
    ladder is not a recompile storm."""
    if drift is None:
        drift = getattr(watchtower, "drift", None)
    if drift is None or not hasattr(drift, "warm_fused"):
        return
    spec = getattr(scorer, "fused_spec", lambda: None)()
    if spec is None:
        return
    out_dtype = scorer_mod.RETURN_WIRES[config.scorer_return_wire()]
    if explain_k is None:
        explain_k = (
            config.scorer_explain_k() if config.scorer_explain() == "topk" else 0
        )
    if spec.explain_args is None:
        explain_k = 0
    explain_k = min(explain_k, scorer.n_features)
    max_batch = max_batch or config.scorer_max_batch()
    top = _bucket(max_batch, scorer.min_bucket)
    b = scorer.min_bucket
    with expected_compiles():
        while b <= top:
            drift.warm_fused(scorer, b, out_dtype=out_dtype, explain_k=explain_k)
            b *= 2


class ModelReloader:
    """Alias watcher and swap for one serving process. Models load on
    ``device`` (default: the slot's model's device)."""

    def __init__(
        self,
        slot: ModelSlot,
        watchtower=None,
        interval: float | None = None,
        device=None,
    ):
        self.slot = slot
        self.watchtower = watchtower
        self.interval = (
            interval if interval is not None else config.lifecycle_reload_interval()
        )
        self.device = device if device is not None else getattr(slot.model, "device", None)
        self._shadow_version: int | None = self._current_shadow_version()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # check_once runs from the poll thread and /admin/reload at once:
        # serialized, so two loads cannot interleave their swaps
        self._lock = lockdep.lock("lifecycle.reloader")
        metrics.lifecycle_active_model_version.set(slot.version or 0)

    # -- registry probes ---------------------------------------------------
    def _registry(self):
        from fraud_detection_tpu_torch.tracking import TrackingClient

        return TrackingClient().registry

    def _current_shadow_version(self) -> int | None:
        try:
            return self._registry().get_version_by_alias(
                config.model_name(), config.shadow_stage()
            )
        except Exception:
            log.debug("shadow alias probe failed", exc_info=True)
            return None

    def _load(self, version: int):
        from fraud_detection_tpu_torch.models import load_any_model

        art = self._registry().artifact_dir(config.model_name(), version)
        return art, load_any_model(art, device=self.device)

    # -- the reload step ---------------------------------------------------
    def check_once(self) -> dict:
        """One alias sweep; returns what changed (the /admin/reload body)."""
        with self._lock:
            out = {"champion": "unchanged", "shadow": "unchanged"}
            try:
                out["champion"] = self._check_champion()
            except Exception as e:
                out["champion"] = f"error: {e}"
                log.warning("champion reload check failed: %s", e)
            try:
                out["shadow"] = self._check_shadow()
            except Exception as e:
                out["shadow"] = f"error: {e}"
                log.warning("shadow reload check failed: %s", e)
            return out

    def _check_champion(self) -> str:
        name, stage = config.model_name(), config.model_stage()
        version = self._registry().get_version_by_alias(name, stage)
        if version is None or version == self.slot.version:
            return "unchanged"
        art, model = self._load(version)
        old = self.slot.model
        if old is not None and _base_names(model) != _base_names(old):
            # the hot-swap condition is the WIRE schema: narrow ↔ widened
            # promotions keep it and must hot-swap
            raise ValueError(
                f"v{version} wire schema differs from the served model — "
                "refusing to hot-swap (deploy instead)"
            )
        warm_scorer(model.scorer)  # build BEFORE the swap
        profile = None
        if self.watchtower is not None:
            from fraud_detection_tpu_torch.monitor.baseline import load_profile

            profile = load_profile(art)
            # a CROSS-WIDTH promotion (narrow ↔ ledger ↔ wide: the widened
            # columns differ) changes the drift window: warm against a
            # monitor built from the NEW champion's profile
            drift_override = None
            if (
                profile is not None
                and old is not None
                and list(model.feature_names) != list(old.feature_names)
            ):
                drift_override = self.watchtower._make_drift(profile)
                if getattr(model, "ledger_spec", None) is not None:
                    # a ledger champion's fused flush is the ledger flush:
                    # warm it over the stamped table (all-padding rows leave
                    # the table as it is)
                    drift_override.bind_ledger(model.ledger_spec, model.ledger_state)
            warm_fused_ladder(self.watchtower, model.scorer, drift=drift_override)
        self.slot.swap(model, f"registry:models:/{name}@{stage}", version)
        if self.watchtower is not None:
            # a widened champion's entity table rebinds WITH the model: the
            # stamped snapshot its weights were replayed against
            ledger = (
                (model.ledger_spec, model.ledger_state)
                if getattr(model, "ledger_spec", None) is not None
                else None
            )
            self.watchtower.rebind_champion(profile, ledger=ledger)
            # rebind_champion drops the shadow scorer (the old challenger is
            # usually the new champion): the shadow sweep right after this
            # re-binds even when the @shadow alias itself did not move
            self._shadow_version = -1
        return f"swapped to v{version}"

    def _check_shadow(self) -> str:
        version = self._current_shadow_version()
        if version == self._shadow_version:
            return "unchanged"
        prev = self._shadow_version
        if self.watchtower is None:
            self._shadow_version = version
            return "unchanged"  # nothing to rebind without a watchtower
        if version is None:
            self.watchtower.rebind_challenger(None, None)
            self._shadow_version = None
            # -1: a champion swap just dropped the challenger itself
            return "unchanged" if prev == -1 else f"challenger v{prev} unloaded"
        # the version is recorded only AFTER a successful bind: a transient
        # registry failure retries on the next poll
        _, challenger = self._load(version)
        served = self.slot.model
        if served is not None and _base_names(challenger) != _base_names(served):
            log.warning("shadow v%s wire schema mismatch — not binding", version)
            self._shadow_version = version  # terminal for this version
            return "schema mismatch"
        warm_scorer(challenger.scorer)
        self.watchtower.rebind_challenger(
            challenger,
            f"registry:models:/{config.model_name()}@{config.shadow_stage()}",
        )
        self._shadow_version = version
        return f"challenger swapped to v{version}"

    # -- polling -----------------------------------------------------------
    def start(self) -> None:
        if self.interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._poll_loop, name="lifecycle-reloader", daemon=True
        )
        self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check_once()
            except Exception:
                log.warning("reloader poll failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

