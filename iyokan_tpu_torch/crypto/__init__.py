from . import host  # noqa: F401
