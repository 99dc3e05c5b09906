from .scheduler import DEFAULT_BURST, Device, Runtime

__all__ = ["DEFAULT_BURST", "Device", "Runtime"]
