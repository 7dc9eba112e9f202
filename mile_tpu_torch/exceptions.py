"""Exceptions of the port."""


class NotYetPortedError(NotImplementedError):
    """A feature of ``mile_tpu`` that the PyTorch port does not have yet.

    Each one has an entry in the port's queue in ``ROADMAP.md``."""

    def __init__(self, feature: str):
        super().__init__(
            f'{feature} is not yet ported to mile_tpu_torch; run it with '
            f'the JAX package (mile_tpu) or see ROADMAP.md for its place '
            f'in the port queue')
