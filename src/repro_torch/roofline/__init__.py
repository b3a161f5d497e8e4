"""Roofline terms of the dry run: one rank's step counted as it runs."""

from repro_torch.roofline.analysis import HW, collective_bytes, roofline_report

__all__ = ["HW", "collective_bytes", "roofline_report"]
