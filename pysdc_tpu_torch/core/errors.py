"""Framework error taxonomy (mirrors reference ``pySDC/core/errors.py:1-79``)."""


class DataError(Exception):
    """Wrong data, e.g. during initialization of a state container."""


class ParameterError(Exception):
    """Wrong or missing parameters."""


class UnlockError(Exception):
    """Level used before it was unlocked by prediction/restriction."""


class CollocationError(Exception):
    """Invalid collocation setup."""


class ConvergenceError(Exception):
    """Iteration failed to converge (e.g. inner Newton/Krylov solve)."""


class TransferError(Exception):
    """Invalid space/time transfer."""


class CommunicationError(Exception):
    """Mismatched send/recv in the time pipeline."""


class ControllerError(Exception):
    """Invalid controller configuration or stage-machine state."""


class ProblemError(Exception):
    """Problem-specific failure (e.g. invalid RHS, solver breakdown)."""


class ReadOnlyError(Exception):
    """Attempt to write a read-only registered parameter."""

    def __init__(self, name):
        super().__init__(f'cannot set read-only attribute {name}')
