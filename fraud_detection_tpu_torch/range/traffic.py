"""Adversarial traffic generators: synthetic fraud campaigns, seeded.

The port's own copy of the JAX package's ``range/traffic.py`` (numpy only):
for the same spec and seed its streams are the reference's bit for bit.
Every generator is a pure function of ``(spec, seed)`` — two runs with the
same seed produce bitwise-identical row streams, which is what lets the
invariant checker assert the drift window ends bitwise-consistent across
repeated scenario runs (range/invariants.py). All rows are Kaggle-schema
shaped (30 float32 features) so they flow through the real scorer,
watchtower, and feedback store unchanged.

Four campaign ingredients, composable per scenario:

- :class:`ArrivalProcess` — heavy-tailed diurnal arrivals: a sinusoidal
  base rate (the millions-of-users day/night shape compressed into the
  scenario's duration) modulated by Pareto-distributed burst multipliers,
  so batch sizes carry the 80/20 burstiness real fraud traffic has;
- :class:`DriftCampaign` — covariate and/or label drift switched on at a
  KNOWN onset row (mean shift + scale stretch on chosen features), so
  detection latency is measurable in rows, not vibes;
- :class:`FraudRing` — a coordinated ring: clusters of rows drawn tightly
  around a shared feature center (correlated feature clusters), injected
  as contiguous runs the way mule networks burst;
- :class:`LabelFeedback` — the label-delay + label-noise model: labels for
  scored rows settle only after ``delay_rows`` more traffic has passed,
  with a configurable flip rate (noisy human review).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

D = 30  # Kaggle schema width: Time + V1..V28 + Amount


def _logistic(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))


@dataclass(frozen=True)
class ArrivalProcess:
    """Heavy-tailed diurnal arrivals, quantized into micro-batches.

    ``rate_hz`` is the mean arrival rate; the instantaneous rate follows
    one diurnal sine period across ``total_rows`` (trough ``1 - depth``,
    peak ``1 + depth`` of the mean) and each collection window's count is
    further multiplied by a Pareto(``burst_alpha``) draw clipped at
    ``burst_cap`` — alpha ≤ 2 gives the infinite-variance burstiness that
    makes p99 meaningful.
    """

    rate_hz: float = 2000.0
    window_s: float = 0.01
    diurnal_depth: float = 0.6
    burst_alpha: float = 1.5
    burst_cap: float = 20.0

    def batch_sizes(self, total_rows: int, rng: np.random.Generator) -> list[int]:
        sizes: list[int] = []
        done = 0
        base = self.rate_hz * self.window_s
        # pre-draw in blocks for determinism independent of loop count
        while done < total_rows:
            phase = done / max(total_rows, 1)
            diurnal = 1.0 + self.diurnal_depth * np.sin(2 * np.pi * phase)
            burst = min(float(rng.pareto(self.burst_alpha)) + 1.0, self.burst_cap)
            n = int(round(base * diurnal * burst))
            n = max(1, min(n, total_rows - done))
            sizes.append(n)
            done += n
        return sizes


@dataclass(frozen=True)
class DriftCampaign:
    """Covariate (and optionally label) drift with a known onset row."""

    onset_row: int
    features: tuple[int, ...] = (0, 3, 7)
    mean_shift: float = 3.0
    scale_stretch: float = 1.0
    label_flip_rate: float = 0.0  # label drift: P(flip) after onset

    def apply(
        self, x: np.ndarray, y: np.ndarray, start_row: int,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Shift the slice of this batch that falls after the onset."""
        n = x.shape[0]
        first = max(0, self.onset_row - start_row)
        if first >= n:
            return x, y
        x = x.copy()
        y = y.copy()
        idx = list(self.features)
        x[first:, idx] = (
            x[first:, idx] * self.scale_stretch + self.mean_shift
        )
        if self.label_flip_rate > 0.0:
            flips = rng.random(n - first) < self.label_flip_rate
            y[first:] = np.where(flips, 1 - y[first:], y[first:])
        return x, y


@dataclass(frozen=True)
class FraudRing:
    """Coordinated fraud ring: correlated feature clusters.

    ``n_rings`` centers are drawn once (far out in feature space along
    ``ring_features``); each injected run is ``ring_size`` consecutive rows
    sampled within ``ring_sigma`` of one center — tight clusters with
    pairwise feature correlation ≈ 1 - sigma², against a background of
    independent rows.
    """

    start_row: int
    n_rings: int = 3
    ring_size: int = 48
    every_rows: int = 512
    ring_features: tuple[int, ...] = (1, 2, 4, 9)
    center_scale: float = 4.0
    ring_sigma: float = 0.15

    def centers(self, rng: np.random.Generator) -> np.ndarray:
        c = np.zeros((self.n_rings, D), np.float32)
        c[:, list(self.ring_features)] = (
            rng.standard_normal((self.n_rings, len(self.ring_features)))
            * self.center_scale
        ).astype(np.float32)
        return c


@dataclass(frozen=True)
class LabelFeedback:
    """Label-delay + label-noise: labels settle ``delay_rows`` of traffic
    after scoring, with ``noise_rate`` of them flipped by review error."""

    delay_rows: int = 2048
    noise_rate: float = 0.0
    batch: int = 256  # rows per delivered feedback batch


@dataclass
class TrafficBatch:
    """One generated micro-batch plus its campaign bookkeeping."""

    rows: np.ndarray          # (n, 30) float32
    labels: np.ndarray        # (n,) int32 ground truth (pre-delay)
    start_row: int            # global index of rows[0]
    ring_mask: np.ndarray     # (n,) bool — True for fraud-ring rows
    drifted: bool             # any row at/after the drift onset


@dataclass
class CampaignSpec:
    """A full scenario's traffic recipe — everything seeded."""

    total_rows: int = 8192
    seed: int = 2026
    w_true: np.ndarray | None = None  # ground-truth boundary (default drawn)
    bias: float = -2.0
    arrivals: ArrivalProcess = field(default_factory=ArrivalProcess)
    drift: DriftCampaign | None = None
    ring: FraudRing | None = None
    feedback: LabelFeedback | None = None


class CampaignTraffic:
    """Iterator over a campaign's micro-batches (deterministic per seed)."""

    def __init__(self, spec: CampaignSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.w_true = (
            spec.w_true
            if spec.w_true is not None
            else self.rng.standard_normal(D).astype(np.float32)
        )
        self._ring_centers = (
            spec.ring.centers(self.rng) if spec.ring is not None else None
        )
        if self._ring_centers is not None:
            # orient each center into the fraud half-space: a coordinated
            # ring is a HIGH-RISK pattern by construction — flip the signs
            # of the cluster coordinates so the ground-truth logit
            # contribution is positive on every ring feature
            f = list(spec.ring.ring_features)
            sign = np.sign(self.w_true[f]).astype(np.float32)
            sign[sign == 0] = 1.0
            self._ring_centers[:, f] = (
                np.abs(self._ring_centers[:, f]) * sign
            )

    def _labels_for(self, x: np.ndarray, ring_mask: np.ndarray) -> np.ndarray:
        p = _logistic(x @ self.w_true + self.spec.bias)
        y = (self.rng.random(x.shape[0]) < p).astype(np.int32)
        y[ring_mask] = 1  # ring rows ARE fraud — that's the campaign
        return y

    def batches(self) -> Iterator[TrafficBatch]:
        spec = self.spec
        start = 0
        ring_budget = 0  # rows left in the currently-injected ring run
        ring_center = 0
        since_ring = spec.ring.every_rows if spec.ring is not None else 0
        for n in spec.arrivals.batch_sizes(spec.total_rows, self.rng):
            x = self.rng.standard_normal((n, D)).astype(np.float32)
            ring_mask = np.zeros(n, bool)
            if spec.ring is not None and start + n > spec.ring.start_row:
                i = 0
                while i < n:
                    if ring_budget > 0:
                        k = min(ring_budget, n - i)
                        c = self._ring_centers[ring_center]
                        x[i : i + k] = (
                            c
                            + self.rng.standard_normal((k, D)).astype(
                                np.float32
                            )
                            * spec.ring.ring_sigma
                        )
                        ring_mask[i : i + k] = True
                        ring_budget -= k
                        i += k
                        continue
                    since_ring += 1
                    if (
                        start + i >= spec.ring.start_row
                        and since_ring >= spec.ring.every_rows
                    ):
                        since_ring = 0
                        ring_budget = spec.ring.ring_size
                        ring_center = int(
                            self.rng.integers(spec.ring.n_rings)
                        )
                    else:
                        i += 1
            y = self._labels_for(x, ring_mask)
            drifted = False
            if spec.drift is not None:
                x, y = spec.drift.apply(x, y, start, self.rng)
                drifted = start + n > spec.drift.onset_row
            yield TrafficBatch(
                rows=x, labels=y, start_row=start, ring_mask=ring_mask,
                drifted=drifted,
            )
            start += n


class DelayedLabelJoiner:
    """The label-settlement model: buffers scored rows and releases labeled
    feedback batches once ``delay_rows`` of further traffic has passed —
    with ``noise_rate`` of labels flipped, the way human review is wrong."""

    def __init__(self, fb: LabelFeedback, seed: int):
        self.fb = fb
        self.rng = np.random.default_rng(seed ^ 0x5EED)
        self._pending: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        self.released_rows = 0
        self.flipped_rows = 0

    def observe(
        self, batch: TrafficBatch, scores: np.ndarray
    ) -> None:
        self._pending.append(
            (batch.start_row, batch.rows, np.asarray(scores, np.float32),
             batch.labels)
        )

    def due(self, current_row: int) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (rows, scores, labels) feedback batches whose delay has
        elapsed by ``current_row``."""
        while self._pending and (
            current_row - self._pending[0][0] >= self.fb.delay_rows
        ):
            _, x, s, y = self._pending.pop(0)
            y = y.copy()
            if self.fb.noise_rate > 0.0:
                flips = self.rng.random(y.shape[0]) < self.fb.noise_rate
                y = np.where(flips, 1 - y, y).astype(np.int32)
                self.flipped_rows += int(flips.sum())
            self.released_rows += int(y.shape[0])
            # re-chunk to the feedback batch size the joiner would POST
            for lo in range(0, y.shape[0], self.fb.batch):
                hi = lo + self.fb.batch
                yield x[lo:hi], s[lo:hi], y[lo:hi]
