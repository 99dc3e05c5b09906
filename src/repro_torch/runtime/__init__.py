from .scheduler import Device, Runtime

__all__ = ["Device", "Runtime"]
