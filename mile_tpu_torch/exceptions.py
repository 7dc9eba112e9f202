"""Exceptions of the port: the JAX package's own (a copy of
``mile_tpu/exceptions.py``) and :class:`NotYetPortedError`."""


class MileTPUError(Exception):
    """Base class for framework errors."""


class MissingConfigError(MileTPUError):
    """A required configuration file or field is absent."""


class ModelNotFoundError(MileTPUError):
    """The configured model name is not in the registry."""


class SamplerNotImplementedError(MileTPUError):
    """The configured sampling mode is not supported."""


class NotYetPortedError(NotImplementedError):
    """A feature of ``mile_tpu`` that the PyTorch port does not have yet.

    Each one has an entry in the port's queue in ``ROADMAP.md``."""

    def __init__(self, feature: str):
        super().__init__(
            f'{feature} is not yet ported to mile_tpu_torch; run it with '
            f'the JAX package (mile_tpu) or see ROADMAP.md for its place '
            f'in the port queue')
