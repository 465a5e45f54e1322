"""Health/observability snapshot: status, version, the service's device,
storage metadata, webhook state and the configured listen address."""

from __future__ import annotations

import torch

import sph_pie_torch


def device_info(device: torch.device | str = "cuda") -> dict:
    """The device the service runs on, from torch: backend ``cuda`` or
    ``cpu``, the count of devices of that backend this process sees, and the
    service's device with the card's name."""
    try:
        device = torch.device(device)
        if device.type == "cuda":
            index = device.index if device.index is not None else torch.cuda.current_device()
            return {
                "backend": "cuda",
                "deviceCount": torch.cuda.device_count(),
                "devices": [f"cuda:{index} {torch.cuda.get_device_name(index)}"],
            }
        return {"backend": device.type, "deviceCount": 1, "devices": [str(device)]}
    except Exception as e:  # device unreachable should not kill /health
        return {"backend": "unavailable", "error": str(e)[:200]}


def health_snapshot(registry=None, webhook=None, config=None, device="cuda") -> dict:
    out = {
        "status": "ok",
        "version": sph_pie_torch.__version__,
        "device": device_info(device),
    }
    if registry is not None:
        try:
            out["storage"] = registry.get_provider().get_storage_metadata()
        except Exception as e:
            out["storage"] = {"error": str(e)[:200]}
            out["status"] = "degraded"
    if webhook is not None:
        out["webhook"] = webhook.get_status()
    if config is not None:
        out["listen"] = {"host": config.get("host"), "port": config.get("port")}
    return out
