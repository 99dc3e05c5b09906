"""A tensor on a device that is neither ``cpu``, ``cuda`` nor ``meta``, for
tests that a kernel wrapper refuses such a device: a wrapper subclass that
declares device ``xpu`` and refuses every op (no such backend is needed to
make one)."""
import torch


class Elsewhere(torch.Tensor):
    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"{func} on {cls.__name__}")
