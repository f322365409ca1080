"""Sensor data types + GPS geodetic->cartesian conversion.

The port's copy of ``uasl_motion_estimation_tpu/utils/sensors.py`` (numpy only).

Host-side equivalents of the reference's data/gps utilities (cold-path by
design, like the originals):

* ``ImuData``/``GpsData``/``PoseData`` with the accumulate (+=) / average
  (/=) semantics used for multirate IMU fusion
  (reference: include/MotionEstimation/core/data_utils.h:17-99);
* geodetic->local-cartesian conversion with per-latitude meter coefficients
  and a configurable origin + rotation
  (include/MotionEstimation/core/gps_utils.h:17-39), as an explicit
  ``GpsFrame`` object instead of the reference's mutable globals.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class TimeUnit(enum.Enum):
    SEC = "sec"
    MILLI = "milli"
    MICRO = "micro"
    NANO = "nano"


@dataclass
class ImuData:
    """Inertial sample (data_utils.h:31-70)."""

    acc: np.ndarray = field(default_factory=lambda: np.zeros(3))
    gyr: np.ndarray = field(default_factory=lambda: np.zeros(3))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0, 0, 0])
    )  # quaternion [w,x,y,z]
    stamp: int = 0
    time_unit: TimeUnit = TimeUnit.SEC

    def __iadd__(self, other: "ImuData"):
        """Accumulate acc/gyr; pos/orientation/stamp take the newest value
        (operator+=, data_utils.h:44-51)."""
        self.acc = self.acc + other.acc
        self.gyr = self.gyr + other.gyr
        self.pos = other.pos
        self.orientation = other.orientation
        self.stamp = other.stamp
        return self

    def __itruediv__(self, nb: int):
        """Average accumulated acc/gyr (operator/=, data_utils.h:65-68)."""
        if nb > 0:
            self.acc = self.acc / nb
            self.gyr = self.gyr / nb
        return self


@dataclass
class GpsData:
    """GNSS sample (data_utils.h:74-86)."""

    lon: float = 0.0
    lat: float = 0.0
    alt: float = 0.0
    stamp: int = 0
    time_unit: TimeUnit = TimeUnit.SEC
    status: int = 0


@dataclass
class PoseData:
    """Pose sample (data_utils.h:90-99)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0, 0, 0])
    )
    stamp: int = 0
    time_unit: TimeUnit = TimeUnit.SEC


# latitude/longitude meter coefficients (gps_utils.h:17-23)
_M1, _M2, _M3, _M4 = 111132.92, -559.82, 1.175, -0.0023
_P1, _P2, _P3 = 111412.84, -93.5, 0.118


@dataclass
class GpsFrame:
    """Local cartesian frame: origin (lat, lon in degrees) + rotation angle.

    Explicit object replacing the reference's static mutable
    ``m_origin``/``m_angle`` globals (gps_utils.h:14-15, 27-30)."""

    origin_lat: float = 0.0
    origin_lon: float = 0.0
    angle: float = 0.0

    def to_cartesian(self, lat: float, lon: float) -> np.ndarray:
        """(x, y) meters of a geodetic coordinate in this local frame
        (getCartesianCoordinate, gps_utils.h:32-39)."""
        phi = np.deg2rad(lat)
        lat_m = _M1 + _M2 * np.cos(2 * phi) + _M3 * np.cos(4 * phi) \
            + _M4 * np.cos(6 * phi)
        lon_m = _P1 * np.cos(phi) + _P2 * np.cos(3 * phi) + _P3 * np.cos(5 * phi)
        gx = (lat - self.origin_lat) * lat_m
        gy = (lon - self.origin_lon) * lon_m
        c, s = np.cos(self.angle), np.sin(self.angle)
        return np.array([s * gx + c * gy, c * gx - s * gy])
