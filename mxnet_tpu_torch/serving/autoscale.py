"""SLO-aware admission policy (the ``SLOPolicy`` half of
``mxnet_tpu/serving/autoscale.py``; the fleet ``Autoscaler`` is not
ported yet).

- **Tiers**: every request carries a ``tier`` — ``latency`` (protected)
  or ``bulk`` (shed first).  Unlabelled requests default to
  ``MXNET_SLO_DEFAULT_TIER``.
- **Weighted-fair queueing**: within a tier, tenants share capacity by
  weight (``MXNET_SLO_TENANT_WEIGHTS``, ``"free=1,pro=4"``) via
  start-time fair queueing; with one tenant the tags degrade to exact
  FIFO order.
- **Deadline infeasibility**: an EMA of the observed service rate sheds
  a request whose deadline provably lands before the queue ahead of it
  drains (typed 503 with ``retry_after``).
"""
from __future__ import annotations

import threading
import time

from .. import config as _config
from .errors import BadRequestError, DeadlineInfeasibleError

__all__ = ["SLOPolicy", "TIERS"]

TIERS = ("latency", "bulk")

#: minimum completed-request samples before the service-rate EMA is
#: trusted for infeasibility shedding (a cold estimator must not shed)
_MIN_RATE_SAMPLES = 3


def _parse_weights(spec):
    """'a=1,b=4' -> {'a': 1.0, 'b': 4.0} (bad entries ignored)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, _, w = part.partition("=")
        try:
            w = float(w)
        except ValueError:
            continue
        if tenant.strip() and w > 0:
            out[tenant.strip()] = w
    return out


class SLOPolicy:
    """Admission policy: tier classification, per-tenant weighted-fair
    queueing tags, and deadline-infeasibility shedding."""

    def __init__(self, *, tenant_weights=None, default_tier=None,
                 ema_alpha=0.3):
        self.weights = (_parse_weights(tenant_weights)
                        if isinstance(tenant_weights, str)
                        else dict(tenant_weights)
                        if tenant_weights is not None
                        else _parse_weights(
                            _config.get("MXNET_SLO_TENANT_WEIGHTS")))
        self.default_tier = str(default_tier
                                or _config.get("MXNET_SLO_DEFAULT_TIER"))
        if self.default_tier not in TIERS:
            self.default_tier = "latency"
        self.ema_alpha = float(ema_alpha)
        self._lock = threading.Lock()
        self._finish = {}      # tenant -> virtual finish tag
        self._vserver = 0.0    # virtual time of the last dispatched tag
        self._rate = 0.0       # EMA completions/s
        self._rate_t = None    # last completion timestamp
        self._rate_samples = 0

    # -- classification ---------------------------------------------------
    def normalize_tier(self, tier):
        if tier is None:
            return self.default_tier
        tier = str(tier)
        if tier not in TIERS:
            raise BadRequestError(
                "unknown tier %r (known: %s)" % (tier, "|".join(TIERS)))
        return tier

    @staticmethod
    def rank(tier):
        """Dispatch priority: latency (0) strictly before bulk (1)."""
        return TIERS.index(tier)

    def weight(self, tenant):
        return self.weights.get(tenant, 1.0) if tenant else 1.0

    # -- weighted-fair queueing (start-time fair queueing) ----------------
    def stamp(self, tier, tenant):
        """Admit one request: returns ``(rank, vstart)`` — the queue's
        sort key.  A tenant's tags advance by ``1/weight`` per request."""
        tier = self.normalize_tier(tier)
        with self._lock:
            start = max(self._vserver,
                        self._finish.get(tenant, 0.0))
            self._finish[tenant] = start + 1.0 / self.weight(tenant)
        return self.rank(tier), start

    def on_dispatch(self, vstart):
        """Advance virtual server time to the dispatched request's tag."""
        with self._lock:
            if vstart > self._vserver:
                self._vserver = vstart

    # -- service-rate estimation / infeasibility --------------------------
    def observe_served(self, n=1, now=None):
        """Feed one service completion (n requests) into the rate EMA."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._rate_t is not None:
                dt = now - self._rate_t
                if dt > 1e-9:
                    inst = n / dt
                    self._rate = (inst if self._rate_samples == 0
                                  else self.ema_alpha * inst
                                  + (1.0 - self.ema_alpha) * self._rate)
                    self._rate_samples += 1
            self._rate_t = now

    def service_rate(self):
        """Observed service rate (requests/s EMA); 0.0 until warm."""
        with self._lock:
            return (self._rate
                    if self._rate_samples >= _MIN_RATE_SAMPLES else 0.0)

    def drain_eta_s(self, depth):
        """Estimated seconds for ``depth`` queued requests to drain at
        the observed service rate; None while the estimator is cold."""
        rate = self.service_rate()
        if rate <= 0.0 or depth <= 0:
            return None
        return depth / rate

    def check_deadline(self, depth, deadline_s):
        """Shed (typed 503) a request whose deadline provably lands
        before the queue ahead of it drains."""
        if deadline_s is None:
            return
        eta = self.drain_eta_s(depth)
        if eta is not None and eta > float(deadline_s):
            raise DeadlineInfeasibleError(
                "deadline %.0f ms is infeasible: %d queued ahead drain "
                "in ~%.0f ms at the observed service rate"
                % (float(deadline_s) * 1e3, depth, eta * 1e3),
                retry_after=max(0.05, eta - float(deadline_s)))
