"""Pluggable sinks for resolved edges — the datastore/ package analog."""

from alaz_tpu_torch.datastore.dto import (
    REQUEST_DTYPE,
    KAFKA_EVENT_DTYPE,
    ALIVE_CONNECTION_DTYPE,
    EP_NONE,
    EP_POD,
    EP_SERVICE,
    EP_OUTBOUND,
    RequestView,
    iter_request_views,
    make_requests,
    reverse_direction,
)
from alaz_tpu_torch.datastore.interface import DataStore, BaseDataStore
from alaz_tpu_torch.datastore.inmem import InMemDataStore
from alaz_tpu_torch.datastore.backend import BatchingBackend, Transport

__all__ = [
    "REQUEST_DTYPE",
    "KAFKA_EVENT_DTYPE",
    "ALIVE_CONNECTION_DTYPE",
    "EP_NONE",
    "EP_POD",
    "EP_SERVICE",
    "EP_OUTBOUND",
    "RequestView",
    "iter_request_views",
    "make_requests",
    "reverse_direction",
    "DataStore",
    "BaseDataStore",
    "InMemDataStore",
    "BatchingBackend",
    "Transport",
]
