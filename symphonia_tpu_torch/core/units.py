"""Time units: timestamps, durations, and rational time bases.

Mirrors symphonia-core/src/units.rs: ``Timestamp`` (i64 ticks), ``Duration``
(u64 ticks), ``Time`` (seconds + fraction) and ``TimeBase`` (rational
seconds-per-tick) with exact integer conversion math (units.rs:19,26,520,932).
Timestamps here are plain Python ints (arbitrary precision, so the reference's
saturating variants are unnecessary).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction


@dataclass(frozen=True)
class Time:
    """A wall-clock instant: whole seconds + fractional seconds [0, 1).

    Reference: units.rs:520 (``Time { seconds: u64, frac: f64 }``).
    """

    seconds: int
    frac: float = 0.0

    @staticmethod
    def from_seconds(secs: float) -> "Time":
        whole = int(secs)
        return Time(whole, secs - whole)

    def to_seconds(self) -> float:
        return self.seconds + self.frac

    def __lt__(self, other: "Time") -> bool:
        return self.to_seconds() < other.to_seconds()


@dataclass(frozen=True)
class TimeBase:
    """Rational number of seconds per timestamp tick (units.rs:932).

    ``numer/denom`` seconds per tick; e.g. 1/44100 for PCM sample ticks.
    """

    numer: int
    denom: int

    def __post_init__(self) -> None:
        if self.numer == 0 or self.denom == 0:
            raise ValueError("TimeBase numerator/denominator must be non-zero")

    def calc_time(self, ts: int) -> Time:
        """Convert a tick count to Time exactly (units.rs calc_time)."""
        product = Fraction(ts * self.numer, self.denom)
        seconds = int(product) if product >= 0 else -int(-product)
        frac = float(product - seconds)
        return Time(seconds, frac)

    def calc_timestamp(self, time: Time) -> int:
        """Convert Time to ticks, truncating toward zero (units.rs calc_timestamp)."""
        total = Fraction(time.seconds) + Fraction(time.frac)
        ticks = total * Fraction(self.denom, self.numer)
        return int(ticks)

    def to_seconds(self, ts: int) -> float:
        return ts * self.numer / self.denom
