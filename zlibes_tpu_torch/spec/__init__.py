from . import constants, errors, refmodel  # noqa: F401
