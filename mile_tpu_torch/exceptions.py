"""Exceptions of the port: a copy of ``mile_tpu/exceptions.py``."""


class MileTPUError(Exception):
    """Base class for framework errors."""


class MissingConfigError(MileTPUError):
    """A required configuration file or field is absent."""


class ModelNotFoundError(MileTPUError):
    """The configured model name is not in the registry."""


class SamplerNotImplementedError(MileTPUError):
    """The configured sampling mode is not supported."""
