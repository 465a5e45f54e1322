"""Run executor: the bridge from run records to actual simulations.

Submitting a run drives the engine on the service's device for the
requested steps, records step metrics into the run record at a fixed
cadence (one epoch of ``record_every`` steps, then one read of the metrics
to the host), checkpoints the final state, and fires lifecycle webhooks. A
single worker thread serialises execution (one card).

A run's ``params`` parameterise the scene builder; they never choose the
device or the dtype, which are the service's: a ``device`` or ``dtype`` key
fails the run.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback

import torch

from sph_pie_torch.scenes import builders
from sph_pie_torch.service import metrics as metrics_lib
from sph_pie_torch.service.storage.base import now_ms
from sph_pie_torch.solvers import pbf as pbf_lib
from sph_pie_torch.solvers import run as run_lib
from sph_pie_torch.utils.checkpoint import CheckpointManager

SERVICE_KEYS = ("device", "dtype")  # chosen by the service, never by a run's params


def service_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises for ``cuda`` without a card
    (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (pass device='cpu' to run on the CPU)"
        )
    return device


def on_device(device: torch.device):
    """Context in which CUDA work (the kernels' current stream included) goes
    to ``device``: ``torch.cuda.device`` on a card, nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class RunExecutor:
    def __init__(self, registry, webhook=None, broadcast=None, checkpoint_dir=None,
                 device: torch.device | str = "cuda"):
        self.device = service_device(device)
        self.registry = registry
        self.webhook = webhook
        self.broadcast = broadcast or (lambda msg: None)
        self.checkpoint_dir = checkpoint_dir
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._lock = threading.Lock()

    def _ensure_worker(self):
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._loop, daemon=True)
                self._worker.start()

    def submit(
        self, run_id: str, scene_id: str, n_steps: int, record_every: int = 50
    ):
        provider = self.registry.get_provider()
        run = provider.get_run(run_id)
        if run is None:
            raise KeyError(run_id)
        run["status"] = "queued"
        run["execution"] = {
            "scene": scene_id,
            "steps": int(n_steps),
            "recordEvery": int(record_every),
            "queuedAt": now_ms(),
        }
        provider.replace_run(run)
        self._q.put((run_id, scene_id, int(n_steps), int(record_every)))
        self._ensure_worker()
        return run

    def pending(self) -> int:
        return self._q.qsize()

    def _loop(self):
        while True:
            try:
                job = self._q.get(timeout=5)
            except queue.Empty:
                # Retire atomically w.r.t. submit(): if a job slipped in
                # between the timeout and here, keep draining; otherwise
                # clear the worker slot under the lock so the next
                # submit() is guaranteed to start a fresh worker.
                with self._lock:
                    if self._q.empty():
                        self._worker = None
                        return
                continue
            with on_device(self.device):
                self._execute(*job)

    def _execute(self, run_id, scene_id, n_steps, record_every):
        provider = self.registry.get_provider()

        def update(**kw):
            run = provider.get_run(run_id)
            if run is None:
                return None
            run.update(kw)
            provider.replace_run(run)
            self.broadcast({"type": "runs:changed", "event": "run.updated", "runId": run_id})
            return run

        try:
            run0 = provider.get_run(run_id) or {}
            builder = getattr(builders, scene_id)
            params0 = dict(run0.get("params") or {})
            # solver selection rides the run params: {"solver": "pbf",
            # "pbf": {...make_pbf_params kwargs...}} runs the constraint
            # solver through the same epoch loop.
            solver = str(params0.pop("solver", "wcsph"))
            pbf_kwargs = dict(params0.pop("pbf", None) or {})
            if solver not in ("wcsph", "pbf"):
                raise ValueError(f"unknown solver {solver!r}")
            taken = [k for k in SERVICE_KEYS if k in params0 or k in pbf_kwargs]
            if taken:
                raise ValueError(f"bad scene params: {taken} are the service's to choose "
                                 f"(it runs on {self.device})")
            t0 = time.perf_counter()
            try:
                # the run's params dict parameterises the scene builder
                scene = builder(**params0, device=self.device)
            except TypeError as e:
                raise ValueError(f"bad scene params: {e}") from e
            pbf_params = None
            if solver == "pbf":
                pbf_params = pbf_lib.make_pbf_params(
                    **pbf_kwargs, dtype=scene.params.h.dtype, device=self.device
                )
            timing = {"buildSeconds": time.perf_counter() - t0}
            update(status="running", startedAt=now_ms())
            state = scene.state
            step = 0
            t0 = time.perf_counter()
            while step < n_steps:
                chunk = min(record_every, n_steps - step)
                state, overflow = run_lib.run_epochs(
                    scene.params,
                    scene.bgrid,
                    state,
                    scene.emitter,
                    scene.obstacles,
                    chunk,
                    1,
                    start_step=step,
                    boundary=scene.boundary,
                    pbf_params=pbf_params,
                )
                step += chunk
                # the one wait for the epoch; the overflow count is then a copy
                m = metrics_lib.state_metrics(state, scene.params, step=step)
                m["overflow"] = int(overflow)
                try:
                    provider.add_step(run_id, {"step": step, **m})
                except Exception:
                    pass  # run may have been archived/deleted mid-flight
                self.broadcast(
                    {"type": "runs:changed", "event": "step.added", "runId": run_id}
                )
            timing["stepSeconds"] = time.perf_counter() - t0
            if self.checkpoint_dir:
                t0 = time.perf_counter()
                CheckpointManager(f"{self.checkpoint_dir}/{run_id}").save(
                    state, scene.params, step=step
                )
                timing["checkpointSeconds"] = time.perf_counter() - t0
            run = update(status="completed", completedAt=now_ms(), timing=timing)
            if self.webhook is not None and run is not None:
                self.webhook.dispatch_run_event("run.completed", run)
        except Exception as e:
            update(
                status="failed",
                error=f"{type(e).__name__}: {e}"[:500],
                failedAt=now_ms(),
            )
            traceback.print_exc()
