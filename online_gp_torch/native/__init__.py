"""The native stream loader: a C++ CSV reader and minibatch ring built with
g++ at first use and bound with ctypes (numpy when it does not build)."""

from online_gp_torch.native.loader import BatchStream, fast_csv_read, native_available

__all__ = ["native_available", "fast_csv_read", "BatchStream"]
