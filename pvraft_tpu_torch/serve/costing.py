"""Dispatch pricing: the service's live view of the cost surface (port of
``pvraft_tpu/serve/costing.py``).

Every dispatched micro-batch is priced through the inventory
(:class:`~pvraft_tpu_torch.programs.costs.CostSurface`: the roofline of
the program's counted flops and bytes at the H100's peaks) and measured
against that price: the predicted device-seconds go to
``pvraft_serve_predicted_device_seconds_total``, the measured dispatch
wall to ``pvraft_serve_device_busy_seconds_total{replica}``, and their
ratio per (bucket, batch, dtype), how far that dispatch sits from the
card's roofline, to the ``cost_calibration`` events, the ``/healthz``
``cost`` block and Prometheus.

A calibration is ``comparable`` only when the pool runs on a TPU and the
prediction came from a record counted on a device: never on the card,
as the shared event schema demands (``obs/events.py`` rejects
``comparable: true`` off a TPU). The ratio is recorded, never enforced.

The price table is computed once, at construction, so the per-dispatch
hook is a dict read and two counter bumps; a disarmed service carries no
model at all (``costing is None`` in the batcher: one attribute check).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from pvraft_tpu_torch.programs.costs import CostEstimate, CostSurface


class ServeCostModel:
    """One serve pool's price table and calibration sink."""

    def __init__(self, surface: CostSurface, buckets: Sequence[int],
                 batch_sizes: Sequence[int], dtype: str, platform: str,
                 metrics=None, telemetry=None):
        self.surface = surface
        self.dtype = dtype
        self.platform = platform
        self.metrics = metrics
        self.telemetry = telemetry
        # Read-only after construction: the executors read it unlocked.
        self._prices: Dict[Tuple[int, int], Optional[CostEstimate]] = {
            (int(b), int(bs)): surface.estimate_serve(b, bs, dtype)
            for b in buckets for bs in batch_sizes}

    def price(self, bucket: int, batch: int) -> Optional[CostEstimate]:
        """The predicted cost of one (bucket, batch) dispatch (None when
        the surface has no serve record at the dtype)."""
        return self._prices.get((int(bucket), int(batch)))

    def coverage(self) -> Dict[str, Any]:
        """What the table knows: the ``/healthz`` ``cost_surface`` block."""
        priced = {k: v for k, v in self._prices.items() if v is not None}
        return {
            "surface": self.surface.path,
            "dtype": self.dtype,
            "platform": self.platform,
            "programs": len(self.surface),
            "priced_geometries": len(priced),
            "extrapolated_geometries": sorted(
                f"b{b}_bs{bs}" for (b, bs), v in priced.items()
                if v.extrapolated),
        }

    def observe_dispatch(self, bucket: int, batch: int, replica: int,
                         t_start: float, t_end: float) -> None:
        """Price and measure one successful dispatch. The batcher calls
        it after the engine call returns; ``t_start`` and ``t_end``
        bracket exactly the ``device_execute`` window the trace marks."""
        est = self.price(bucket, batch)
        if est is None:
            return
        measured_s = max(0.0, t_end - t_start)
        comparable = self.platform == "tpu" and est.comparable
        if self.metrics is not None:
            self.metrics.record_cost(
                bucket=bucket, batch=batch, dtype=self.dtype,
                replica=replica, predicted_s=est.device_seconds,
                measured_s=measured_s, t_start=t_start, t_end=t_end,
                comparable=comparable, extrapolated=est.extrapolated)
        if self.telemetry is not None:
            self.telemetry.emit_cost_calibration(
                bucket=bucket, batch=batch, dtype=self.dtype,
                predicted_s=round(est.device_seconds, 9),
                measured_s=round(measured_s, 6),
                platform=self.platform, comparable=comparable,
                replica=replica, basis=est.basis,
                extrapolated=est.extrapolated, program=est.name)
