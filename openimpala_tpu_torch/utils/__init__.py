"""Direction helpers, device rule, step timing and sample volumes."""

from .common import DIRECTIONS, direction_name, parse_direction

__all__ = ["parse_direction", "DIRECTIONS", "direction_name"]
