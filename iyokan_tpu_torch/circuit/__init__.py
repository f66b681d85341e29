from .netlist import Design  # noqa: F401
from .blueprint import Blueprint  # noqa: F401
