"""Native (C++) runtime components, loaded via ctypes (counterpart of
``mile_tpu.native``). Built at first use; each has a numpy fallback."""
from mile_tpu_torch.native.sink import NativeSampleSink, native_available  # noqa: F401
