"""Helpers of the port that touch no device."""

from .flops import get_model_flops_per_token

__all__ = ["get_model_flops_per_token"]
