"""A configuration file and a traffic file -> a `Config` of the port's
shape, built from either side's config module (the port's
`thinktwice_tpu_torch.config` or the reference's `ttref.config`), so both
sides run the sizes the files state."""

from __future__ import annotations


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def make_config(conf: dict, traffic: dict, config_module):
    """The world's sizes from the traffic file (`sim`), the model's from the
    configuration file (`birdview`, `roach`, `camera`, `lidar`, `model`,
    and `image_size` [rows, cols] for the cameras and the student's input)."""
    m = config_module
    kw = {"sim": m.SimConfig(**traffic["sim"])}
    if "birdview" in conf:
        kw["birdview"] = m.BirdviewConfig(**_tuples(conf["birdview"]))
    if "roach" in conf:
        kw["roach"] = m.RoachConfig(**_tuples(conf["roach"]))
    if "image_size" in conf:
        rows, cols = conf["image_size"]
        kw["camera"] = m.CameraConfig(height=rows, width=cols, **_tuples(conf["camera"]))
        kw["model"] = m.ModelConfig(img_height=rows, img_width=cols, **_tuples(conf["model"]))
        kw["lidar"] = m.LidarConfig(**_tuples(conf["lidar"]))
    return m.Config(**kw)
