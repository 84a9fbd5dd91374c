"""Weather as a 10-float parameter vector (counterpart of
`thinktwice_tpu/sim/weather.py`, the part the rollout reads).

Layout (indices): 0 cloudiness, 1 precipitation, 2 precipitation_deposits,
3 wind_intensity, 4 sun_azimuth_angle, 5 sun_altitude_angle, 6 wetness,
7 fog_distance, 8 fog_density, 9 fog_falloff, in CARLA's units.
"""

from __future__ import annotations

import numpy as np

(W_CLOUD, W_RAIN, W_DEPOSITS, W_WIND, W_AZIMUTH, W_ALTITUDE, W_WETNESS,
 W_FOG_DIST, W_FOG_DENSITY, W_FOG_FALLOFF) = range(10)


def make_weather(cloudiness=0.0, precipitation=0.0, precipitation_deposits=0.0,
                 wind_intensity=0.0, sun_azimuth_angle=0.0,
                 sun_altitude_angle=70.0, wetness=0.0, fog_distance=100.0,
                 fog_density=0.0, fog_falloff=1.0) -> np.ndarray:
    return np.asarray(
        [cloudiness, precipitation, precipitation_deposits, wind_intensity,
         sun_azimuth_angle, sun_altitude_angle, wetness, fog_distance,
         fog_density, fog_falloff],
        np.float32,
    )


# the route-XML default: cloudiness 30, sun altitude 70
DEFAULT = make_weather(cloudiness=30.0, sun_altitude_angle=70.0)
