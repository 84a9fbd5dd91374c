"""Milliseconds of the sensors a policy call: the spans around
`cameras_from_state` and `lidar_from_state`, summed over the window and
divided by its policy calls."""


def read(run: dict):
    cams, lidar = run["spans"].get("cameras_from_state"), run["spans"].get("lidar_from_state")
    calls = run.get("policy_calls")
    return (sum(cams) + sum(lidar)) / calls if cams and lidar and calls else None
