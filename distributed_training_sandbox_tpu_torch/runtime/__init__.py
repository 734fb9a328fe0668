"""The hot-loop machinery every training twin runs through, and the
serving engine's pump: :class:`DevicePrefetcher` (``prefetch.py``) stages
batches on the card ahead of the step, :class:`StepPump` (``pump.py``)
retires results with a declared host-sync policy."""

from .prefetch import DevicePrefetcher, sharded_put
from .pump import StepPump

__all__ = ["DevicePrefetcher", "StepPump", "sharded_put"]
