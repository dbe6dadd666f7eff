"""Where the port writes what it builds at run time."""

from __future__ import annotations

import pathlib


def build_root() -> pathlib.Path:
    """``build/`` at the root of the checkout (listed in ``.gitignore``)."""
    return pathlib.Path(__file__).resolve().parents[1] / "build"
