"""Device-memory telemetry: periodic samples of the card's allocator
(port of ``pvraft_tpu/obs/device_memory.py``), as ``device_memory``
events on the ``pvraft_events/v1`` stream and as the
``pvraft_device_hbm_bytes{device}`` and ``pvraft_device_hbm_peak_bytes``
Prometheus gauges (``serve/metrics.py``).

A row per CUDA device, from ``torch.cuda.memory_stats(device)``:

  ``bytes_in_use``       ``allocated_bytes.all.current``
  ``peak_bytes_in_use``  ``allocated_bytes.all.peak``
  ``bytes_limit``        ``torch.cuda.mem_get_info(device)[1]`` (the
                         card's total memory)

with ``device_id`` and ``platform`` ``"gpu"``. It reads *allocated*
bytes, not *reserved* ones, because JAX's ``bytes_in_use`` counts live
buffers; PyTorch's reserved bytes also hold the caching allocator's free
blocks, and the serve engine's captured graphs keep their private pools
there (``compile_report()``'s ``pool_bytes``), which would read as
memory in use. The CPU has no allocator statistics: no rows, no events.
The probe never raises: a sampler must not take down the service it
observes.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock

# memory_stats() key -> row key.
_STAT_KEYS = (("allocated_bytes.all.current", "bytes_in_use"),
              ("allocated_bytes.all.peak", "peak_bytes_in_use"))


def _index(device) -> int:
    if isinstance(device, torch.device):
        return device.index if device.index is not None else 0
    return int(device)


def device_memory_row(device) -> Optional[Dict[str, Any]]:
    """One CUDA device's row, or None when the allocator reports nothing
    or the probe fails (never raises)."""
    try:
        stats = torch.cuda.memory_stats(device)
    except Exception:  # noqa: BLE001 — no allocator, no row
        return None
    if not stats or stats.get(_STAT_KEYS[0][0]) is None:
        return None
    row: Dict[str, Any] = {"device_id": _index(device), "platform": "gpu"}
    for src, dst in _STAT_KEYS:
        if stats.get(src) is not None:
            row[dst] = int(stats[src])
    try:
        row["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    except Exception:  # noqa: BLE001 — the limit is optional
        pass
    return row


def sample_device_memory(devices=None) -> List[Dict[str, Any]]:
    """Rows of ``devices`` (default: every CUDA device; none on a
    machine without one) that report statistics."""
    if devices is None:
        devices = (range(torch.cuda.device_count())
                   if torch.cuda.is_available() else ())
    rows = []
    for device in devices:
        row = device_memory_row(device)
        if row is not None:
            rows.append(row)
    return rows


class DeviceMemoryMonitor:
    """The service's sampler thread: every ``interval_s`` seconds one
    sample of all (or the given) devices, emitted as one
    ``device_memory`` event and pushed into
    ``metrics.record_device_memory``. ``interval_s <= 0`` never starts
    the thread. ``stop()`` samples once more, so a short-lived service
    still records its last watermark."""

    def __init__(self, emit: Optional[Callable[..., Any]] = None,
                 metrics=None, interval_s: float = 10.0,
                 devices=None, context: str = "serve"):
        self.emit = emit
        self.metrics = metrics
        self.interval_s = float(interval_s)
        self.devices = devices
        self.context = context
        self.samples = 0
        self._stop = threading.Event()
        # start/stop swap the thread under one lock, so two callers can
        # neither start two samplers nor join a replaced one.
        self._state_lock = ordered_lock("DeviceMemoryMonitor._state_lock")
        self._thread: Optional[threading.Thread] = None  # guarded-by: _state_lock

    def sample_once(self) -> List[Dict[str, Any]]:
        rows = sample_device_memory(self.devices)
        if rows:
            self.samples += 1
            if self.metrics is not None:
                self.metrics.record_device_memory(rows)
            if self.emit is not None:
                self.emit(rows, context=self.context)
        return rows

    def start(self) -> None:
        with self._state_lock:
            if self.interval_s <= 0 or self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pvraft-devmem", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — observe, never crash serving
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        # Joined under the lifecycle lock, which the sampler never takes.
        with self._state_lock:
            thread = self._thread
            if thread is None:
                return
            self._thread = None
            self._stop.set()
            thread.join(5.0)
        try:
            self.sample_once()
        except Exception:  # noqa: BLE001 — shutdown must complete
            pass
