from .pump import StepPump

__all__ = ["StepPump"]
