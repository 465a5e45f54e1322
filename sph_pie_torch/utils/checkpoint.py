"""Checkpoint / resume: explicit snapshots of the flat particle state.

One ``.npz`` per snapshot holds the state's fields (``state.<field>``), the
parameters' tensors (``params.<field>``) and, as JSON bytes under
``__meta__``, the format version, the step, caller extras and the
parameters' plain values (``params_static``). It is written atomically
(a dot-prefixed temp file, then a rename) and read with numpy alone. The
keys are the JAX package's, so a file saved by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.core.state import ParticleState

FORMAT_VERSION = 1


def save_state(
    path: str | Path,
    state: ParticleState,
    params: FluidParams | None = None,
    step: int = 0,
    extra: dict | None = None,
) -> Path:
    """Atomic snapshot (temp file + rename) of state [+ params/meta]."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        f"state.{f.name}": getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }
    meta = {"version": FORMAT_VERSION, "step": int(step), "extra": extra or {}}
    if params is not None:
        for f in dataclasses.fields(params):
            v = getattr(params, f.name)
            if isinstance(v, (int, float)):
                meta.setdefault("params_static", {})[f.name] = v
            else:
                arrays[f"params.{f.name}"] = v.detach().cpu().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    # Dot-prefixed temp name: it must not match the manager's 'ckpt_*.npz'
    # glob, or a crash between write and rename leaves a file that breaks
    # the rotation. It ends in .npz so numpy appends no extension.
    tmp = path.parent / f".{path.stem}.tmp.npz"
    np.savez_compressed(tmp, **arrays)
    tmp.replace(path)
    return path


def load_state(path: str | Path, device: torch.device | str = "cuda"):
    """Returns (state, params or None, step, extra), tensors on ``device``."""
    with np.load(Path(path)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} too new")

        def section(prefix):
            return {
                k.split(".", 1)[1]: torch.tensor(z[k], device=device)
                for k in z.files
                if k.startswith(prefix)
            }

        state = ParticleState(**section("state."))
        pf = section("params.")
    params = None
    if pf:
        pf.update(meta.get("params_static", {}))
        params = FluidParams(**pf)
    return state, params, meta["step"], meta.get("extra", {})


class CheckpointManager:
    """Rotating snapshots: ckpt_<step>.npz, the newest ``keep`` retained."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep

    def _all(self) -> list[Path]:
        found = []
        for p in self.dir.glob("ckpt_*.npz"):
            try:
                found.append((int(p.stem.split("_")[1]), p))
            except ValueError:
                continue  # a stray file never breaks the rotation
        return [p for _, p in sorted(found)]

    def save(self, state, params=None, step: int = 0, extra=None) -> Path:
        path = save_state(self.dir / f"ckpt_{step}.npz", state, params, step, extra)
        for old in self._all()[: -self.keep]:
            old.unlink(missing_ok=True)
        return path

    def latest(self) -> Path | None:
        all_ = self._all()
        return all_[-1] if all_ else None

    def restore_latest(self, device: torch.device | str = "cuda"):
        latest = self.latest()
        if latest is None:
            return None
        return load_state(latest, device)
