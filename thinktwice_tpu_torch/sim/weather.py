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


def parse_weather_elem(route_elem) -> np.ndarray:
    """<weather .../> children of a <route> element -> (10,) params; without
    one, DEFAULT. Attributes a <weather> does not set keep sun altitude 0
    and fog distance 100; later elements override earlier ones."""
    w = route_elem.find("weather")
    if w is None:
        return DEFAULT.copy()
    out = make_weather(sun_altitude_angle=0.0, fog_distance=100.0)
    names = {
        "cloudiness": W_CLOUD,
        "precipitation": W_RAIN,
        "precipitation_deposits": W_DEPOSITS,
        "wind_intensity": W_WIND,
        "sun_azimuth_angle": W_AZIMUTH,
        "sun_altitude_angle": W_ALTITUDE,
        "wetness": W_WETNESS,
        "fog_distance": W_FOG_DIST,
        "fog_density": W_FOG_DENSITY,
        "fog_falloff": W_FOG_FALLOFF,
    }
    for elem in route_elem.iter("weather"):
        for name, idx in names.items():
            if name in elem.attrib:
                out[idx] = float(elem.attrib[name])
    return out


def is_night(weather) -> bool:
    """Night mode: the sun below the horizon."""
    return float(weather[W_ALTITUDE]) < 0.0
