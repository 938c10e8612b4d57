"""Trace persistence: save/replay columnar event streams as NPZ.

The reference has no trace format (its tests re-fabricate traffic each
run); recorded traces make replays byte-identical across the CPU-reference
and TPU paths — the parity requirement in SURVEY §7 hard part (e).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List

import numpy as np

from alaz_tpu_torch.events.k8s import (
    EventType,
    K8sResourceMessage,
    Pod,
    ResourceType,
    Service,
)

_RESOURCE_CLASSES = {"Pod": Pod, "Service": Service}


def save_trace(
    path: str | Path,
    kube_msgs: List[K8sResourceMessage],
    tcp_events: np.ndarray,
    l7_batches: Iterator[np.ndarray],
) -> None:
    path = Path(path)
    l7 = list(l7_batches)
    l7_all = np.concatenate(l7) if l7 else np.zeros(0)
    kube_json = json.dumps(
        [
            {
                "resource_type": m.resource_type.value,
                "event_type": m.event_type.value,
                "kind": type(m.object).__name__,
                "object": m.object.__dict__,
            }
            for m in kube_msgs
            if type(m.object).__name__ in _RESOURCE_CLASSES
        ]
    )
    np.savez_compressed(
        path,
        tcp=tcp_events,
        l7=l7_all,
        kube=np.frombuffer(kube_json.encode(), dtype=np.uint8),
    )


def load_trace(path: str | Path):
    """→ (kube_msgs, tcp_events, l7_events)."""
    with np.load(path) as z:
        kube_json = bytes(z["kube"]).decode()
        tcp = z["tcp"]
        l7 = z["l7"]
    msgs = []
    for item in json.loads(kube_json):
        cls = _RESOURCE_CLASSES[item["kind"]]
        obj = cls(**item["object"])
        msgs.append(
            K8sResourceMessage(
                ResourceType(item["resource_type"]),
                EventType(item["event_type"]),
                obj,
            )
        )
    return msgs, tcp, l7
