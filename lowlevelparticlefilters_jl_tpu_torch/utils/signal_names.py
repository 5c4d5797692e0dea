"""Named signals for plot legends (counterpart of
``utils/signal_names.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SignalNames:
    """Names of state/input/output signals (signalnames.jl:11-30).

    Plain metadata stored on filters.
    """

    x: tuple = field(default=())
    u: tuple = field(default=())
    y: tuple = field(default=())
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "x", tuple(self.x))
        object.__setattr__(self, "u", tuple(self.u))
        object.__setattr__(self, "y", tuple(self.y))


def default_names(nx: int, nu: int, ny: int, name: str = "") -> SignalNames:
    return SignalNames(
        x=tuple(f"x{i + 1}" for i in range(nx)),
        u=tuple(f"u{i + 1}" for i in range(nu)),
        y=tuple(f"y{i + 1}" for i in range(ny)),
        name=name,
    )
