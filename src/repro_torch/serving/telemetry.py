"""Serving telemetry: a dispatch-cost ring buffer with periodic online θ
refit.

Every dispatch the scheduler times is recorded as a row

    (features, predicted_ms, measured_ms)

where ``features`` is the group's batch-summed feature vector over the
planner's ``COEFF_KEYS`` basis (core/planner.py) — the same columns
``scripts/torch_fit_cost_model.py`` fits offline, derived from the very
estimate the scheduler predicted the dispatch with, so

    predicted_ms == features @ coeff_vector(θ)

holds by construction at record time.  Periodically (every ``refit_every``
records, once ``min_samples`` rows exist) the buffer re-solves the same
least-squares regression the offline fit runs — restricted to the columns
the serving trace actually exercises, clamped non-negative, and blended with
the incumbent θ for stability — and hands the scheduler an updated
coefficient dict.  Prediction error therefore SHRINKS during serving instead
of requiring an offline ``torch_fit_cost_model`` run: an unfitted host starts on
the package defaults and calibrates itself from its own dispatch stream
(the paper's "within 10% of optimal 90% of the time" accuracy claim, made a
live property instead of an offline one).

The ring buffer is bounded (``capacity``) so a long-running server tracks
the RECENT cost regime — after a workload shift the stale rows age out and
the refit follows.

The port's copy of the reference package's ``serving/telemetry.py``, over
the port's ``COEFF_KEYS``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from ..core.planner import COEFF_KEYS, coeff_vector, fit_linear


@dataclasses.dataclass
class DispatchSample:
    """One timed dispatch: the prediction made and the truth measured."""
    features: np.ndarray        # [len(COEFF_KEYS)] batch-summed feature row
    predicted_ms: float
    measured_ms: float


def _abs_rel_err(pred: np.ndarray, meas: np.ndarray) -> np.ndarray:
    return np.abs(pred - meas) / np.maximum(np.abs(meas), 1e-9)


class TelemetryBuffer:
    """Bounded (predicted, measured) dispatch log + online θ refit.

    ``refit=False`` turns the buffer into a pure error recorder (the
    static-θ baseline the benches compare the online fit against).
    ``blend`` is the fraction of the fresh least-squares solution mixed into
    the incumbent θ per refit (1.0 = jump straight to the new fit).
    """

    def __init__(self, capacity: int = 512, refit_every: int = 32,
                 min_samples: int = 8, blend: float = 0.5,
                 refit: bool = True):
        assert capacity >= min_samples >= 2
        self.capacity = capacity
        self.refit_every = refit_every
        self.min_samples = min_samples
        self.blend = blend
        self.refit_enabled = refit
        self._rows: Deque[DispatchSample] = deque(maxlen=capacity)
        #: full-trace error log (never truncated — the report's raw series)
        self.errors: List[float] = []
        self.n_recorded = 0
        self.n_refits = 0

    # -------------------------------------------------------------- recording
    def record(self, features: np.ndarray, predicted_ms: float,
               measured_ms: float) -> None:
        self._rows.append(DispatchSample(np.asarray(features, float),
                                         float(predicted_ms),
                                         float(measured_ms)))
        self.errors.append(float(_abs_rel_err(
            np.asarray(predicted_ms), np.asarray(measured_ms))))
        self.n_recorded += 1

    def __len__(self) -> int:
        return len(self._rows)

    def should_refit(self) -> bool:
        return (self.refit_enabled
                and len(self._rows) >= self.min_samples
                and self.n_recorded % self.refit_every == 0)

    # ---------------------------------------------------------------- refit
    def refit(self, coeffs: dict) -> dict:
        """One online refit pass: least squares over the buffered rows on the
        columns this trace exercises, non-negative, blended into ``coeffs``.

        Returns the updated coefficient dict (also suitable for
        ``planner.coeffs.update``).  Columns the trace never exercised keep
        their incumbent values — a dense-only serving trace cannot perturb
        the partitioned exchange terms, and vice versa.
        """
        X = np.stack([s.features for s in self._rows])
        y = np.asarray([s.measured_ms for s in self._rows])
        theta = coeff_vector(coeffs)
        # only columns with signal in THIS trace participate in the solve;
        # the incumbent values of the rest are moved to the left-hand side so
        # the active columns fit the residual (the offline fit's two-stage
        # residual regression, generalised to whatever columns are live)
        active = np.any(X != 0.0, axis=0)
        if not np.any(active):
            return dict(coeffs)
        resid = y - X[:, ~active] @ theta[~active]
        sol = fit_linear(X[:, active], resid)
        new = theta.copy()
        new[active] = np.maximum(
            (1.0 - self.blend) * theta[active] + self.blend * sol, 0.0)
        self.n_refits += 1
        out = dict(coeffs)
        out.update({k: float(new[i]) for i, k in enumerate(COEFF_KEYS)
                    if active[i]})
        return out

    # -------------------------------------------------------------- reporting
    def error_stats(self, tail: Optional[int] = None) -> dict:
        """Mean/p90 absolute relative prediction error — over the whole
        recorded trace and (``tail_*``) its final stretch, where the online
        refit has had samples to learn from.

        Always returns a well-defined NaN-free dict: an empty buffer is all
        zeros, ``tail`` is clamped to the recorded length (``tail=0`` means
        an empty tail → 0.0, not whole-trace stats via ``e[-0:]``)."""
        if not self.errors:
            return dict(n=0, mean_abs_rel_err=0.0, p90_abs_rel_err=0.0,
                        tail_mean_abs_rel_err=0.0, n_refits=self.n_refits)
        e = np.asarray(self.errors)
        if tail is None:
            k = max(1, len(e) // 2)
        else:
            k = max(0, min(int(tail), len(e)))
        return dict(
            n=len(e),
            mean_abs_rel_err=float(e.mean()),
            p90_abs_rel_err=float(np.percentile(e, 90)),
            tail_mean_abs_rel_err=float(e[-k:].mean()) if k else 0.0,
            n_refits=self.n_refits,
        )
