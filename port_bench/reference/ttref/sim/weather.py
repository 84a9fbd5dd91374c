"""Weather as a 10-float parameter vector (counterpart of
`thinktwice_tpu/sim/weather.py`): the layout, the route-XML default, the
preset table and the route XML's <weather> element.

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

# CARLA preset approximations for the WEATHERS table ('1'..'14'): Noon =
# altitude 70, Sunset = 15; Wet adds wetness, Rain adds precipitation
# (+deposits), Cloudy / Wet add cloudiness; HardRain adds fog density.
PRESETS = {
    "ClearNoon": make_weather(5, 0, 0, 10, 0, 70),
    "ClearSunset": make_weather(5, 0, 0, 10, 0, 15),
    "CloudyNoon": make_weather(80, 0, 0, 10, 0, 70),
    "CloudySunset": make_weather(80, 0, 0, 10, 0, 15),
    "WetNoon": make_weather(20, 0, 50, 10, 0, 70, wetness=50),
    "WetSunset": make_weather(20, 0, 50, 10, 0, 15, wetness=50),
    "MidRainyNoon": make_weather(80, 30, 50, 40, 0, 70, wetness=40,
                                 fog_density=5),
    "MidRainSunset": make_weather(80, 30, 50, 40, 0, 15, wetness=40,
                                  fog_density=5),
    "WetCloudyNoon": make_weather(90, 0, 50, 10, 0, 70, wetness=50),
    "WetCloudySunset": make_weather(90, 0, 50, 10, 0, 15, wetness=50),
    "HardRainNoon": make_weather(90, 80, 80, 60, 0, 70, wetness=80,
                                 fog_density=15),
    "HardRainSunset": make_weather(90, 80, 80, 60, 0, 15, wetness=80,
                                   fog_density=15),
    "SoftRainNoon": make_weather(70, 15, 30, 30, 0, 70, wetness=20),
    "SoftRainSunset": make_weather(70, 15, 30, 30, 0, 15, wetness=20),
}

# the numeric keys of the reference's WEATHERS dict
WEATHERS = {str(i + 1): w for i, w in enumerate(PRESETS.values())}

