from .autoscale import Autoscaler
from .scheduler import DEFAULT_BURST, Device, Runtime

__all__ = ["Autoscaler", "DEFAULT_BURST", "Device", "Runtime"]
