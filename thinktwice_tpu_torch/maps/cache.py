"""Disk cache of compiled towns (counterpart of `thinktwice_tpu/maps/cache.py`).

`compile_town` runs a raster A* over every route polyline on the host,
minutes of one core for Town05 with its training bank. The result is a flat
set of arrays, so it round-trips losslessly through one .npz file. The file
holds the JAX package's layout (one array per TownMap field, integer
indices as int32) and the cache key is its signature, so a file written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from thinktwice_tpu_torch.maps.town import TownMap, town_from_arrays

# the package's gitignored build directory, unless the variable names another
CACHE_DIR = os.environ.get(
    "THINKTWICE_TOWN_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "towns"),
)


def save_town(path: str, town: TownMap) -> None:
    arrs = {}
    for f in dataclasses.fields(TownMap):
        a = getattr(town, f.name).detach().cpu().numpy()
        arrs[f.name] = a.astype(np.int32) if a.dtype == np.int64 else a
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrs)


def load_town(path: str, device="cuda") -> TownMap:
    with np.load(path) as z:
        return town_from_arrays({k: z[k] for k in z.files}, device)


def town05_cached(
    h5_path: str,
    routes_files: list[str],
    n_bank_files: int = 4,
    max_bank_routes: int = 200,
    town: str | None = None,
    device="cuda",
    read=None,
    **compile_kwargs,
) -> TownMap:
    """Compile (or load) a town keyed on the H5 file, the route sources and
    the compile arguments.

    routes_files: XML files whose routes seed the lane network (evaluation
    routes first, then training-bank files for town-wide NPC coverage).
    town: when set, keep only the routes declared for that town and cap the
    bank (non-first-file) routes at max_bank_routes; a multi-town route file
    (routes_longest6.xml spans Town01-06) needs it, since another town's
    keypoints planned over this town's raster give nonsense polylines.
    read: path -> the town's rasters, for a town kept in another format
    than an H5 (maps.compile_h5.read_town_h5 unless given); the key holds
    the path and its mtime either way."""
    sig = {
        "h5": h5_path,
        "h5_mtime": os.path.getmtime(h5_path),
        "routes": routes_files,
        "n_bank": n_bank_files,
        "max_bank": max_bank_routes,
        "kwargs": {k: str(v) for k, v in sorted(compile_kwargs.items())},
        "v": 13,  # the JAX package's version of compile_town and the planner
    }
    if town is not None:
        sig["town"] = town
        sig["clsver"] = 2    # the ratio-based junction classifier
    key = hashlib.sha1(json.dumps(sig, sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(CACHE_DIR, f"town_{key}.npz")
    if os.path.exists(path):
        return load_town(path, device)

    from thinktwice_tpu_torch.harness.route_parser import parse_routes_file
    from thinktwice_tpu_torch.maps.compile_h5 import compile_town, read_town_h5
    from thinktwice_tpu_torch.maps.router import raster_planner

    planner = raster_planner(h5_path, read=read)
    polylines = []
    n_bank = 0
    for fi, f in enumerate(routes_files):
        for s in parse_routes_file(f):
            if town is not None:
                if s.town != town:
                    continue
                if fi > 0:
                    if n_bank >= max_bank_routes:
                        break
                    n_bank += 1
            polylines.append(s.dense(spacing=2.0, planner=planner))
    town_map = compile_town(h5_path, polylines, device=device, read=read or read_town_h5,
                            **compile_kwargs)
    save_town(path, town_map)
    return town_map
