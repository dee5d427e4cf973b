"""Utilities: telemetry, code description, the traffic model."""

from .telemetry import (ThroughputMeter, describe,
                        kernel_traffic, traffic_report)

__all__ = ["ThroughputMeter", "describe"]
